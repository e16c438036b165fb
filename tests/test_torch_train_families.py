"""The port's training loss and its backward against the reference for
every architecture at reduced config: the loss, its ``nll`` and ``aux``
metrics and every gradient leaf, from the reference's parameters
(``interop.lm_from_arrays``) on the same seeded batch, against
``jax.value_and_grad(LM.loss_fn)`` (tolerances in ``tests/_torch_lm.py``).

This covers the MoE aux loss and its router gradient (mixtral, qwen2-moe),
the SSD chunk scan (mamba2: 64 tokens in 16-token chunks), the hybrid's
shared block, whose one set of weights takes the sum of its invocations'
gradients (zamba2), whisper's encoder, cross attention and learned
positions, and the VLM's tanh-gated cross blocks (their zero-initialised
gates receive gradient although their outputs start at zero)."""

import pytest

torch = pytest.importorskip("torch")

from _torch_lm import check_train_parity  # noqa: E402
from repro_torch.configs import LM_ARCHS  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' tensors are small: torch's thread pool costs more
    than it gives on them, and under several test workers it oversubscribes
    the host's cores (a CPU setting; no result depends on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    mets = check_train_parity(arch)
    moe = arch in ("mixtral-8x7b", "qwen2-moe-a2.7b")
    assert (mets["aux"] > 0) == moe  # the load-balance loss is the MoE's alone
