"""Port parity for the IVF index: ``repro_torch.index.ivf.search_ivf_fused``
on the reference-built ``fused_idx`` (carried across with ``interop``)
against ``repro.index.ivf.search_ivf_fused(use_ref=True)``, and the port's
own ``build_ivf`` against the reference build's recall."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_carry import carry_ivf, recall  # noqa: E402
from repro.core import exact_knn as j_exact_knn  # noqa: E402
from repro.index.ivf import search_ivf_fused as j_search  # noqa: E402
from repro_torch.core.topk import exact_knn as t_exact_knn  # noqa: E402
from repro_torch.index.ivf import build_ivf as t_build_ivf  # noqa: E402
from repro_torch.index.ivf import search_ivf_fused as t_search  # noqa: E402


@pytest.fixture(scope="module")
def ref_search(fused_idx, queries):
    d, i, st = j_search(fused_idx, jnp.asarray(queries), k=10, n_probe=6,
                        use_ref=True)
    return np.asarray(d), np.asarray(i), st


@pytest.fixture(scope="module")
def gt(aniso_corpus, queries):
    _, ids = j_exact_knn(jnp.asarray(queries), jnp.asarray(aniso_corpus), 10)
    return np.asarray(ids)


def test_search_ivf_fused_matches_reference(fused_idx, queries, ref_search):
    d_ref, i_ref, st_ref = ref_search
    d, i, st = t_search(carry_ivf(fused_idx), queries, k=10, n_probe=6)
    np.testing.assert_array_equal(i.numpy(), i_ref)
    # Squared distances are qn + cn - 2 q·c in float32, summed in another
    # order: equal to 1e-6 of the squared norms involved.
    norm_sq = 4.0 * float(np.max(np.sum(np.asarray(queries) ** 2, axis=1)))
    np.testing.assert_allclose(d.numpy() ** 2, d_ref ** 2, rtol=1e-6,
                               atol=1e-6 * norm_sq)
    # The fetch ledgers count tile decisions, so they are equal.
    assert st.fetched_bytes_per_query == st_ref.fetched_bytes_per_query
    assert st.bytes_per_query == st_ref.bytes_per_query
    assert (st.s1_tiles_fetched, st.s2_slabs_fetched, st.s2_slabs_total) == (
        st_ref.s1_tiles_fetched, st_ref.s2_slabs_fetched, st_ref.s2_slabs_total)
    assert st.rows_per_query == st_ref.rows_per_query
    assert st.passed_per_query == st_ref.passed_per_query


def test_port_build_recall_close_to_reference(fused_idx, aniso_corpus, queries, gt):
    """The builds draw from different random streams, and on this 32-bucket
    fixture recall at a few probes swings by several points between seeds
    of either build; at 24 of 32 probes it no longer depends on the draw.
    The reference's recall is read through the carried index, whose ids
    equal the reference search's (test above)."""
    idx = t_build_ivf(aniso_corpus, n_clusters=32, delta_d=16,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    assert idx.starts.numpy()[:-1].tolist() == sorted(idx.starts.numpy()[:-1].tolist())
    assert np.all(idx.starts.numpy() % 128 == 0)
    ids = idx.flat_ids.numpy()
    assert sorted(ids[ids >= 0].tolist()) == list(range(len(aniso_corpus)))
    _, i, _ = t_search(idx, queries, k=10, n_probe=24)
    _, i_ref, _ = t_search(carry_ivf(fused_idx), queries, k=10, n_probe=24)
    r_port, r_ref = recall(i.numpy(), gt), recall(i_ref.numpy(), gt)
    assert r_port >= r_ref - 0.02, (r_port, r_ref)
    _, gt_port = t_exact_knn(queries, aniso_corpus, 10, device="cpu")
    assert recall(gt_port.numpy(), gt) == 1.0
