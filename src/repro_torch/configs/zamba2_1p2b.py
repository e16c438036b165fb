"""zamba2-1.2b — Mamba2 backbone + weight-shared attention block
[arXiv:2411.15242]. Shared block invoked every 6 mamba layers (HF release
adds per-invocation LoRA deltas — omitted, noted in DESIGN.md)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000, ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    attn_every=6, rope_theta=10000.0,
    grad_accum=2,
)

def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=500, ssm_state=16, ssm_head_dim=16, attn_every=2,
        ssm_chunk=16, dtype="float32", remat=False, q_chunk=32, loss_chunk=64)
