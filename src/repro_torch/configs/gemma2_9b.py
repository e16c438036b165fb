"""gemma2-9b — alternating local(SWA 4096)/global attention, logit softcaps,
sandwich norms [arXiv:2408.00118]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma2-9b", family="dense",
    num_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000, activation="geglu",
    tie_embeddings=True, embed_scale=True,
    sliding_window=4096, window_pattern="alternate",
    attn_softcap=50.0, final_softcap=30.0, post_block_norm=True,
    grad_accum=2,
)

def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, sliding_window=8,
        dtype="float32", remat=False, q_chunk=32, loss_chunk=64)
