"""deepseek-coder-33b — llama-arch dense decoder [arXiv:2401.14196]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="deepseek-coder-33b", family="dense",
    num_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=19200, vocab_size=32256, rope_theta=100000.0,
    grad_accum=2, pad_heads_to=64,
)

def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=160, vocab_size=512, dtype="float32", remat=False,
        q_chunk=32, loss_chunk=64)
