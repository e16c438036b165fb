"""The port's LM serving path against the reference for the four families
beyond dense and MoE (``tests/test_torch_lm.py`` holds those): mamba2
(ssm), zamba2 (hybrid), whisper (encdec) and llama-3.2-vision (vlm), at
reduced config, prefill and decode through ``interop.lm_from_arrays`` on
the reference's parameters (tolerance in ``tests/_torch_lm.py``)."""

import pytest

torch = pytest.importorskip("torch")

from _torch_lm import check_lm_parity  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.model import DEC_POS_ROWS  # noqa: E402


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_ssm_and_hybrid_prefill_decode_match_reference(arch):
    """40 prompt tokens: not a multiple of the 16-token SSD chunk, so the
    chunk padding runs; zamba2's 5 layers run 2 groups of 2 mamba layers
    with the shared attention block after each, then a 1-layer tail."""
    assert reduced_config(arch).ssm_chunk == 16
    assert check_lm_parity(arch, s=40) == 0


def test_whisper_prefill_decode_match_reference():
    assert check_lm_parity("whisper-small") == 0


def test_whisper_positions_past_the_table_clamp_as_reference():
    """``dec_pos`` has 32,768 rows: a 32-token prefill starting 4 rows
    before its end clamps its start back to row 32,736
    (``lax.dynamic_slice_in_dim``), and decode steps at positions
    32,764-32,775 read the last row from 32,767 on."""
    assert check_lm_parity("whisper-small", pos0=DEC_POS_ROWS - 4, s=32,
                           decode_steps=12) == 0


def test_vlm_prefill_decode_match_reference():
    """llama-3.2-vision: 2 gated cross-attention blocks, each before a group
    of 2 self-attention layers, over 16 stub vision embeddings."""
    assert check_lm_parity("llama-3.2-vision-11b") == 0
