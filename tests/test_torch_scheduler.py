"""Port parity for the batching front end: ``repro_torch.runtime.scheduler.
BatchScheduler`` against ``repro.runtime.scheduler.BatchScheduler`` on the
same requests, step and chaos drills — watermark, deadline, retry with its
backoff, retry exhaustion and queue overload shedding — with equal
statuses, results, stats, backoff sleeps and ``serve.*`` counters."""

import json
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.obs as j_obs  # noqa: E402
import repro.runtime.chaos as j_chaos  # noqa: E402
import repro.runtime.scheduler as j_sched  # noqa: E402
import repro_torch.obs as t_obs  # noqa: E402
import repro_torch.runtime.chaos as t_chaos  # noqa: E402
import repro_torch.runtime.scheduler as t_sched  # noqa: E402

PORT = (t_sched, t_chaos, t_obs)
REF = (j_sched, j_chaos, j_obs)


def _step(calls):
    def step(qs):
        calls.append(qs.copy())
        if qs[0, 0] < -100:
            raise RuntimeError("poisoned batch")
        return qs[:, :1] * 2.0, np.arange(len(qs))[:, None] + 10 * len(calls)
    return step


def _serve(pkg, *, chaos=None, requests, sched_kw, deadlines=None, monkeypatch):
    """Run ``requests`` through one package's scheduler under ``chaos``;
    returns everything observable."""
    sched_mod, chaos_mod, obs = pkg
    sleeps = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    reg = obs.MetricsRegistry()
    calls = []
    with chaos_mod.use_chaos(chaos_mod.parse_chaos(chaos, registry=reg) if chaos else None):
        s = sched_mod.BatchScheduler(_step(calls), batch_size=4, registry=reg, **sched_kw)
        reqs = [s.submit(q, deadline_s=(deadlines or {}).get(i))
                for i, q in enumerate(requests)]
        done = s.drain(force=True)
    return dict(
        statuses=[r.status for r in reqs], done=[r.rid for r in done],
        results=[None if r.result is None else (r.result[0].tolist(), r.result[1].tolist())
                 for r in reqs],
        calls=[c.tolist() for c in calls], stats=s.stats, sleeps=sleeps,
        snapshot=json.dumps(reg.snapshot(), sort_keys=True))


def _requests(seed=0, sizes=(3, 5, 1, 4, 2)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, 3)).astype(np.float32) + 5.0 for n in sizes]


@pytest.mark.parametrize("case", [
    dict(sched_kw={}),
    dict(sched_kw=dict(max_queue_rows=6)),
    dict(sched_kw=dict(max_queue_rows=9), chaos="queue_overload:rows=4"),
    dict(sched_kw={}, deadlines={1: -1.0, 3: 60.0}),
    dict(sched_kw=dict(max_retries=2, retry_backoff_s=0.003), chaos="step_error:count=3"),
    dict(sched_kw=dict(max_retries=1, retry_backoff_s=0.01),
         chaos="step_error:after=1:count=3"),
    dict(sched_kw=dict(max_retries=0), chaos="step_error:after=2"),
], ids=["plain", "watermark", "overload", "deadline", "retry_backoff", "retry_exhausted",
        "no_retry"])
def test_batch_scheduler_matches_reference_under_drills(case, monkeypatch):
    reqs = _requests()
    kw = dict(requests=reqs, sched_kw=case["sched_kw"], chaos=case.get("chaos"),
              deadlines=case.get("deadlines"), monkeypatch=monkeypatch)
    port, ref = _serve(PORT, **kw), _serve(REF, **kw)
    assert port == ref
    st = port["stats"]
    assert st["submitted"] == st["served"] + st["shed_queue"] + st["shed_deadline"] \
        + st["shed_error"]
    if "retry" in str(case["sched_kw"]):
        assert port["sleeps"], "the drill never retried"


def test_engine_fault_retries_then_sheds_and_serving_continues(monkeypatch):
    """A real step fault (not a drill) retries like a drill and, retries
    exhausted, sheds its batch's requests; the next batch is served."""
    reqs = _requests(sizes=(2, 2, 4))
    reqs[0][0, 0] = -1000.0  # poisons the first batch
    kw = dict(requests=reqs, sched_kw=dict(max_retries=1, retry_backoff_s=0.002),
              monkeypatch=monkeypatch)
    port, ref = _serve(PORT, **kw), _serve(REF, **kw)
    assert port == ref
    assert port["statuses"] == ["shed_error", "shed_error", "served"]
    assert port["sleeps"] == [0.002] and port["stats"]["retries"] == 1
