"""mamba2-130m — SSD state-space model [arXiv:2405.21060]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    rope_theta=0.0, tie_embeddings=True,
)

def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, vocab_size=503, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=16, dtype="float32", remat=False,
        q_chunk=32, loss_chunk=64)
