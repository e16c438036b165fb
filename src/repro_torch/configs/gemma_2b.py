"""gemma-2b — GeGLU, head_dim=256, MQA [arXiv:2403.08295]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma-2b", family="dense",
    num_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000, activation="geglu",
    tie_embeddings=True, embed_scale=True,
    grad_accum=2,
)

def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, dtype="float32", remat=False,
        q_chunk=32, loss_chunk=64)
