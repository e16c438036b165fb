"""whisper-small — enc-dec audio transformer backbone [arXiv:2212.04356].
Conv frontend is a stub per assignment: input_specs() provides precomputed
frame embeddings (B, 1500, d_model)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-small", family="encdec",
    num_layers=12, encoder_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, encoder_seq=1500,
    norm="layernorm", activation="gelu", rope_theta=0.0,
)

def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=501, encoder_seq=16,
        dtype="float32", remat=False, q_chunk=32, loss_chunk=64)
