"""qwen2-moe-a2.7b — 60 routed experts top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, moe_d_ff=1408, shared_d_ff=5632, vocab_size=151936,
    num_experts=60, experts_per_tok=4, rope_theta=1000000.0,
    grad_accum=2, moe_renorm=False,
)

def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=32, moe_d_ff=32, shared_d_ff=128, vocab_size=512, num_experts=8,
        experts_per_tok=4, dtype="float32", remat=False,
        q_chunk=32, loss_chunk=64)
