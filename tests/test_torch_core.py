"""Port parity for core/ and quant/: transforms, calibration, estimator
tables and the int8 encoders, each held against ``repro`` on the same
numpy inputs (the port runs on the CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_carry import carry_estimator  # noqa: E402
from repro.core import calibration as j_calib  # noqa: E402
from repro.core import estimators as j_est  # noqa: E402
from repro.core.transforms import fit_pca as j_fit_pca  # noqa: E402
from repro.quant import scalar as j_scalar  # noqa: E402
from repro_torch.core import calibration as t_calib  # noqa: E402
from repro_torch.core import estimators as t_est  # noqa: E402
from repro_torch.core.transforms import fit_pca as t_fit_pca  # noqa: E402
from repro_torch.quant import scalar as t_scalar  # noqa: E402


def _spread_data(n=3000, dim=16, seed=0):
    """Well-separated spectrum (relative eigen-gaps >= 2%), so a float32
    and a float64 eigensolver agree on every direction to ~1e-6."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim)) * np.linspace(3.0, 0.5, dim)
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    return (x @ q).astype(np.float32)


def test_fit_pca_matches_reference():
    data = _spread_data()
    ref = j_fit_pca(jnp.asarray(data))
    port = t_fit_pca(data, device="cpu")
    # float32 (reference) against float64 (port) eigensolves: the
    # variances agree to float32 rounding of the projected data.
    np.testing.assert_allclose(port.variances.numpy(), np.asarray(ref.variances),
                               rtol=1e-4)
    np.testing.assert_allclose(port.cum_variances.numpy(),
                               np.asarray(ref.cum_variances), rtol=1e-4)
    b_ref, b_port = np.asarray(ref.basis), port.basis.numpy()
    sign = np.sign(np.sum(b_ref * b_port, axis=0))
    np.testing.assert_allclose(b_port * sign, b_ref, atol=1e-5)


def _ref_pairs(key, n, num_pairs):
    k1, k2 = jax.random.split(key)
    i = np.asarray(jax.random.randint(k1, (num_pairs,), 0, n))
    j = np.asarray(jax.random.randint(k2, (num_pairs,), 0, n))
    return i, j


@pytest.mark.parametrize("p_s,delta_d", [(0.1, 16), (0.02, 32)])
def test_calibrate_with_explicit_pairs_matches(aniso_corpus, p_s, delta_d):
    data = np.asarray(aniso_corpus)[:2000]
    key = jax.random.PRNGKey(5)
    ref_t = j_fit_pca(jnp.asarray(data))
    ref = j_calib.calibrate(ref_t, jnp.asarray(data), key, p_s=p_s,
                            delta_d=delta_d, num_pairs=1024)
    port_est = carry_estimator(j_est.Estimator("dade", ref_t, ref))
    port = t_calib.calibrate(port_est.transform, data, p_s=p_s,
                             delta_d=delta_d, pairs=_ref_pairs(key, 2000, 1024))
    assert np.array_equal(port.dims.numpy(), np.asarray(ref.dims))
    np.testing.assert_array_equal(port.scale.numpy(), np.asarray(ref.scale))
    # Quantiles of ratios whose rotated differences sum in another order:
    # equal to float32 rounding.
    np.testing.assert_allclose(port.eps.numpy(), np.asarray(ref.eps),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.eps_lo.numpy(), np.asarray(ref.eps_lo),
                               rtol=1e-5, atol=1e-6)


def test_adsampling_table_and_schedule_match(method_estimator_factory):
    ref = method_estimator_factory("adsampling")
    port = carry_estimator(ref)
    t = t_calib.adsampling_table(port.transform, delta_d=16)
    r = j_calib.adsampling_table(ref.transform, delta_d=16)
    for a, b in zip((t.dims, t.eps, t.scale, t.eps_lo), (r.dims, r.eps, r.scale, r.eps_lo)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(t_calib.expansion_schedule(100, 32).numpy(),
                          np.asarray(j_calib.expansion_schedule(100, 32)))


@pytest.mark.parametrize("method", ["fdscanning", "adsampling", "dade"])
@pytest.mark.parametrize("block_d", [8, 16, 32])
def test_blocked_schedule_and_kernel_spec_match(method_estimator_factory,
                                                method, block_d):
    ref = method_estimator_factory(method)
    port = carry_estimator(ref)
    dim = int(np.asarray(ref.table.dims)[-1])
    for a, b in zip(t_est.blocked_schedule(port.table, dim, block_d),
                    j_est.blocked_schedule(ref.table, dim, block_d)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ts = t_est.kernel_spec(port, dim, block_d)
    rs = j_est.kernel_spec(ref, dim, block_d)
    assert (ts.block_d, ts.d_pad, ts.s_steps) == (rs.block_d, rs.d_pad, rs.s_steps)
    for a, b in ((ts.eps, rs.eps), (ts.scale, rs.scale), (ts.eps_lo, rs.eps_lo)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(t_est.first_enabled_eps(ts.eps).numpy(),
                                  np.asarray(j_est.first_enabled_eps(rs.eps)))


@pytest.mark.parametrize("method", ["pca_fixed", "rp_fixed"])
def test_fixed_dim_methods_refused_by_name(aniso_corpus, method):
    with pytest.raises(t_est.UnsupportedMethodError, match=method):
        t_est.build_estimator(method, np.asarray(aniso_corpus)[:500], device="cpu")
    # A hand-built table with an approximate terminal is refused structurally,
    # as the reference refuses it.
    ref = j_est.build_estimator(method, np.asarray(aniso_corpus)[:500],
                                jax.random.PRNGKey(0), fixed_dim=32)
    with pytest.raises(j_est.UnsupportedMethodError):
        j_est.kernel_spec(ref, 64, 16)
    with pytest.raises(t_est.UnsupportedMethodError, match=method):
        t_est.kernel_spec(carry_estimator(ref), 64, 16)


@pytest.mark.parametrize("method", ["fdscanning", "adsampling", "dade"])
def test_build_estimator_methods_run(aniso_corpus, method):
    est = t_est.build_estimator(method, np.asarray(aniso_corpus)[:1000],
                                torch.Generator().manual_seed(1), delta_d=16,
                                device="cpu")
    spec = t_est.kernel_spec(est, 64, 16)
    assert spec.s_steps == 4 and float(spec.eps[-1]) == 0.0
    basis = est.transform.basis
    assert torch.allclose(basis.T @ basis, torch.eye(64), atol=1e-4)


def _quant_inputs(seed, n=64, dim=48):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, dim)) * np.exp(-0.05 * np.arange(dim))).astype(np.float32)
    x[3, :16] = 0.0  # an all-zero block in one row
    x[:, 32:40] = 0.0  # an all-zero block across the corpus: scale 0
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("block_d", [8, 16])
def test_block_quantizers_bit_equal(seed, block_d):
    x = _quant_inputs(seed)
    bs_t = t_scalar.fit_block_scales(torch.as_tensor(x), block_d)
    bs_j = j_scalar.fit_block_scales(jnp.asarray(x), block_d)
    np.testing.assert_array_equal(bs_t.numpy(), np.asarray(bs_j))
    np.testing.assert_array_equal(
        t_scalar.quantize_block(torch.as_tensor(x), bs_t, block_d).numpy(),
        np.asarray(j_scalar.quantize_block(jnp.asarray(x), bs_j, block_d)))
    # The band is a cumulative sum, which XLA scans in another order.
    np.testing.assert_allclose(
        t_scalar.block_err_cum(bs_t, block_d=block_d).numpy(),
        np.asarray(j_scalar.block_err_cum(bs_j, block_d=block_d)), rtol=1e-6)
    qc_t, qs_t = t_scalar.quantize_queries_block(torch.as_tensor(x * 3.0), block_d)
    qc_j, qs_j = j_scalar.quantize_queries_block(jnp.asarray(x * 3.0), block_d)
    np.testing.assert_array_equal(qc_t.numpy(), np.asarray(qc_j))
    np.testing.assert_array_equal(qs_t.numpy(), np.asarray(qs_j))
    sc_t = t_scalar.fit_scales(torch.as_tensor(x))
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(j_scalar.fit_scales(jnp.asarray(x))))
    np.testing.assert_array_equal(
        t_scalar.quantize(torch.as_tensor(x), sc_t).numpy(),
        np.asarray(j_scalar.quantize(jnp.asarray(x), jnp.asarray(sc_t.numpy()))))


def test_quantize_rounds_half_to_even_like_reference():
    scales = np.ones(8, np.float32)
    x = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 200.0, -3.49]], np.float32)
    np.testing.assert_array_equal(
        t_scalar.quantize(torch.as_tensor(x), torch.as_tensor(scales)).numpy(),
        np.asarray(j_scalar.quantize(jnp.asarray(x), jnp.asarray(scales))))
