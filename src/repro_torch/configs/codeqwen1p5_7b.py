"""codeqwen1.5-7b — qwen1.5-arch dense decoder [hf:Qwen/CodeQwen1.5-7B]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab_size=92416, rope_theta=1000000.0,
    grad_accum=2, kv_cache_dtype="int8",  # MHA cache: int8 (+per-token
    # scales) quarters the bf16 cache at decode_32k (the reference's choice)
)

def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, dtype="float32", remat=False,
        q_chunk=32, loss_chunk=64)
