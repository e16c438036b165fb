"""The port's write-ahead log (``repro_torch.checkpoint.wal``) against the
reference's ``repro.checkpoint.wal``: the same mutation sequence logged by
both packages gives identical file bytes (an upsert's vector given as
numpy or as a tensor, a recalibrated table as tensors or jax arrays); each
package replays the other's log into an index equal to the live one; a
torn tail is truncated by either opener, a digest mismatch refuses in
both, and a ``torn_upsert`` crash in one package recovers in the other.
Every comparison is exact (bytes, arrays, ids)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.index.mutable as j_mut  # noqa: E402
from _torch_carry import carry_estimator  # noqa: E402
from repro.checkpoint.wal import MutationLog as JLog  # noqa: E402
from repro.checkpoint.wal import replay_into as j_replay_into  # noqa: E402
from repro.core.estimators import build_estimator  # noqa: E402
from repro.runtime.chaos import ChaosError as JChaosError  # noqa: E402
from repro.runtime.chaos import parse_chaos as j_parse_chaos  # noqa: E402
from repro.runtime.chaos import use_chaos as j_use_chaos  # noqa: E402
from repro_torch.checkpoint.wal import MutationLog, replay_into  # noqa: E402
from repro_torch.index.mutable import MutableGraph  # noqa: E402
from repro_torch.runtime.chaos import ChaosError, parse_chaos, use_chaos  # noqa: E402


@pytest.fixture(scope="module")
def base(aniso_corpus):
    """(corpus, reference estimator, port estimator, port factory,
    reference factory): a 60-row graph in each package."""
    corpus = np.asarray(aniso_corpus)[:60]
    est = build_estimator("dade", jnp.asarray(corpus), jax.random.PRNGKey(0), delta_d=16)
    pest = carry_estimator(est)
    kw = dict(m=6, ef_construction=16, capacity=90, quant="int8")
    return (corpus, est, pest,
            lambda: MutableGraph(corpus, estimator=pest, device="cpu", **kw),
            lambda: j_mut.MutableGraph(corpus, estimator=est, **kw))


def _sequence(corpus, as_tensor):
    """A churn sequence: upserts (some vectors as tensors), deletes."""
    ops = []
    for i in range(5):
        vec = (corpus[i] + 0.01 * (i + 1)).astype(np.float32)
        ops.append(("upsert", 60 + i, torch.as_tensor(vec) if as_tensor and i % 2 else vec))
    ops += [("delete", 2, None), ("delete", 61, None)]
    return ops


def _log(log, ops, table):
    for op, gid, vec in ops:
        if op == "upsert":
            log.append_upsert(gid, vec)
        else:
            log.append_delete(gid)
    log.append_set_table(table)
    log.close()


def test_same_mutations_give_identical_file_bytes(base, tmp_path):
    corpus, est, pest, _, _ = base
    _log(MutationLog(str(tmp_path / "p.wal")), _sequence(corpus, True), pest.table)
    _log(JLog(str(tmp_path / "j.wal")), _sequence(corpus, False), est.table)
    assert (tmp_path / "p.wal").read_bytes() == (tmp_path / "j.wal").read_bytes()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_replays_the_others_log(base, tmp_path, writer):
    """The log of one package, replayed by the other into a fresh base,
    reproduces the writer's live index (the port's arrays checked against
    the port's live index, the reference's against the reference's)."""
    corpus, est, pest, port_base, ref_base = base
    path = str(tmp_path / "m.wal")
    ops = _sequence(corpus, writer == "port")
    live = port_base() if writer == "port" else ref_base()
    log = MutationLog(path) if writer == "port" else JLog(path)
    for op, gid, vec in ops:
        if op == "upsert":
            log.append_upsert(gid, vec)
            assert live.upsert(vec) == gid
        else:
            log.append_delete(gid)
            assert live.delete(gid)
    log.close()
    if writer == "port":
        recovered = ref_base()
        counts = j_replay_into(recovered, JLog(path).replay())
        # The reference recovers what the port's log says: same ids, same
        # tombstones, and the rows the port logged, bit for bit.
        assert recovered.tombstones == live.tombstones
        assert recovered.count == live.count
        np.testing.assert_array_equal(recovered._corpus[: live.count],
                                      live._corpus[: live.count])
        again = port_base()
        replay_into(again, MutationLog(path).replay())
        assert torch.equal(again.index.neighbors, live.index.neighbors)
    else:
        recovered = port_base()
        counts = replay_into(recovered, MutationLog(path).replay())
        assert recovered.tombstones == live.tombstones
        np.testing.assert_array_equal(recovered._corpus[: live.count],
                                      np.asarray(live._corpus[: live.count]))
        mirror = port_base()
        for op, gid, vec in ops:
            (mirror.upsert(vec) if op == "upsert" else mirror.delete(gid))
        assert torch.equal(recovered.index.neighbors, mirror.index.neighbors)
        assert torch.equal(recovered.index.adj_ids, mirror.index.adj_ids)
    assert counts == {"upsert": 5, "delete": 2, "set_table": 0}


def test_set_table_round_trips_across_packages(base, tmp_path):
    corpus, est, pest, port_base, _ = base
    _log(JLog(str(tmp_path / "j.wal")), [], est.table)
    recs = MutationLog(str(tmp_path / "j.wal")).replay()
    g = port_base()
    table = g.estimator.table
    assert replay_into(g, recs) == {"upsert": 0, "delete": 0, "set_table": 1}
    assert g.estimator.transform is pest.transform
    for name in ("dims", "eps", "scale", "eps_lo"):
        assert torch.equal(getattr(g.estimator.table, name), getattr(table, name))
        assert getattr(g.estimator.table, name).dtype == getattr(table, name).dtype


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_torn_tail_truncated_by_either_opener(base, tmp_path, writer):
    corpus = base[0]
    path = tmp_path / "m.wal"
    log = MutationLog(str(path)) if writer == "port" else JLog(str(path))
    for i in range(3):
        log.append_upsert(60 + i, corpus[i])
    log.close()
    size = path.stat().st_size
    with open(path, "ab") as f:
        f.write(b"\x00\x00\x01\x00partial")
    reader = JLog(str(path)) if writer == "port" else MutationLog(str(path))
    assert reader.recovered_torn and path.stat().st_size == size
    assert [r["seq"] for r in reader.replay()] == [1, 2, 3]
    assert reader.append_delete(0) == 4
    reader.close()


def test_digest_mismatch_refuses_in_both(base, tmp_path):
    corpus = base[0]
    path = tmp_path / "m.wal"
    log = MutationLog(str(path))
    log.append_upsert(60, corpus[0])
    log.append_delete(3)
    log.close()
    raw = bytearray(path.read_bytes())
    raw[10] ^= 0xFF  # inside record 1's payload
    path.write_bytes(bytes(raw))
    for opener in (MutationLog, JLog):
        with pytest.raises(IOError, match="digest mismatch"):
            opener(str(path))


@pytest.mark.parametrize("crasher", ["port", "reference"])
def test_torn_upsert_crash_recovers_in_the_other_package(base, tmp_path, crasher):
    """A ``torn_upsert`` crash in one package's log: the other package's
    opener truncates the torn record, and replaying its complete prefix
    gives the live state (the torn mutation was never applied)."""
    corpus, _, _, port_base, ref_base = base
    path = str(tmp_path / "m.wal")
    live = port_base() if crasher == "port" else ref_base()
    log = MutationLog(path) if crasher == "port" else JLog(path)
    for i in range(4):
        log.append_upsert(live.count, corpus[i] + 0.5)
        live.upsert(corpus[i] + 0.5)
    log.append_delete(7)
    live.delete(7)
    if crasher == "port":
        with use_chaos(parse_chaos("torn_upsert")):
            with pytest.raises(ChaosError, match="torn upsert"):
                log.append_upsert(live.count, corpus[9])
    else:
        with j_use_chaos(j_parse_chaos("torn_upsert")):
            with pytest.raises(JChaosError, match="torn upsert"):
                log.append_upsert(live.count, corpus[9])
    log.close()
    reader = JLog(path) if crasher == "port" else MutationLog(path)
    assert reader.recovered_torn
    recs = reader.replay()
    assert len(recs) == 5
    recovered = ref_base() if crasher == "port" else port_base()
    (j_replay_into if crasher == "port" else replay_into)(recovered, recs)
    assert recovered.count == live.count and recovered.tombstones == live.tombstones
    assert reader.append_upsert(recovered.count, corpus[9]) == 6
    reader.close()
