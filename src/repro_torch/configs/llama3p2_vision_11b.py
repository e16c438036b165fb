"""llama-3.2-vision-11b — gated cross-attn image layers every 5 self layers
[hf:meta-llama/Llama-3.2-11B-Vision]. ViT frontend is a stub per assignment:
input_specs() provides projected patch embeddings (B, 1601, d_model)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, rope_theta=500000.0,
    cross_every=5, vision_seq=1601, vision_dim=4096,
    grad_accum=4,
)

def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, cross_every=2, vision_seq=16, vision_dim=64,
        dtype="float32", remat=False, q_chunk=32, loss_chunk=64)
