"""mixtral-8x7b — 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, moe_d_ff=14336, vocab_size=32000,
    num_experts=8, experts_per_tok=2,
    sliding_window=4096, window_pattern="all",
    grad_accum=4,
)

def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, moe_d_ff=128, vocab_size=512, num_experts=4,
        experts_per_tok=2, sliding_window=8,
        dtype="float32", remat=False, q_chunk=32, loss_chunk=64)
