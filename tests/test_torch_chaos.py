"""Port parity for the chaos harness: ``repro_torch.runtime.chaos`` parses
every spec as ``repro.runtime.chaos`` does, refuses the same bad ones, and
spends the same budgets on the same hook sequence (events and
``serve.fault.*`` counters alike)."""

import dataclasses
import json

import pytest

pytest.importorskip("torch")

import repro.obs as j_obs  # noqa: E402
import repro.runtime.chaos as j_chaos  # noqa: E402
import repro_torch.obs as t_obs  # noqa: E402
import repro_torch.runtime.chaos as t_chaos  # noqa: E402

SPECS = [
    "shard_death:shard=1:after=2",
    "shard_stall:ms=40:after=1:count=3",
    "step_error",
    "queue_overload:rows=512",
    "slab_corruption:leaf=3",
    "torn_upsert:after=2",
    "stale_transform:after=1",
    "shard_death:shard=0;step_error:after=1:count=2;shard_stall:ms=0.5",
]


def test_fault_kinds_equal_reference():
    assert t_chaos.FAULT_KINDS == j_chaos.FAULT_KINDS


@pytest.mark.parametrize("spec", SPECS)
def test_parse_equals_reference(spec):
    t, j = t_chaos.parse_chaos(spec), j_chaos.parse_chaos(spec)
    assert [dataclasses.asdict(s) for s in t.specs] == [dataclasses.asdict(s) for s in j.specs]


@pytest.mark.parametrize("bad", [
    "flaky_disk", "shard_death", "shard_stall", "queue_overload", "shard_death:shard",
    "shard_death:shard=1:volts=9", " ; ",
])
def test_bad_specs_refused_alike(bad):
    for mod in (t_chaos, j_chaos):
        with pytest.raises(ValueError):
            mod.parse_chaos(bad)


def _drill(mod, obs, spec):
    """One fixed hook sequence against a controller: the clock, waves,
    step errors, queue pressure and the snapshot, corruption, upsert and
    transform hooks, recording what fired."""
    reg = obs.MetricsRegistry()
    c = mod.parse_chaos(spec, registry=reg)
    log = []
    for step in range(6):
        c.on_engine_step()
        for w in range(3):
            c.on_wave(w)
        try:
            c.maybe_fail_step()
            log.append("ok")
        except mod.ChaosError:
            log.append("error")
        log.append((c.queue_pressure(), sorted(c.dead_shards(2)), c.degraded_now(),
                    c.take_corruption() is not None, c.take_torn_upsert() is not None,
                    c.stale_transform_active()))
    events = [{k: v for k, v in e.items()} for e in c.events]
    return log, events, json.dumps(reg.snapshot(), sort_keys=True)


@pytest.mark.parametrize("spec", [
    "step_error:after=1:count=2;queue_overload:rows=7:after=3",
    "shard_stall:ms=0.01:after=2:count=4;shard_death:shard=1:after=1",
    "slab_corruption:after=2;torn_upsert:after=3;stale_transform:after=4",
])
def test_budgets_and_events_equal_reference(spec):
    assert _drill(t_chaos, t_obs, spec) == _drill(j_chaos, j_obs, spec)


def test_null_chaos_is_inert_and_restored():
    assert t_chaos.current_chaos() is t_chaos.NULL_CHAOS
    n = t_chaos.NULL_CHAOS
    n.on_engine_step(), n.on_wave(3), n.maybe_fail_step()
    assert (n.dead_shards(4), n.degraded_now(), n.queue_pressure(), n.take_corruption(),
            n.take_torn_upsert(), n.stale_transform_active()) == (
        frozenset(), False, 0, None, None, False)
    c = t_chaos.parse_chaos("step_error")
    with t_chaos.use_chaos(c):
        assert t_chaos.current_chaos() is c
        with t_chaos.use_chaos(None):
            assert t_chaos.current_chaos() is t_chaos.NULL_CHAOS
        assert t_chaos.current_chaos() is c
    assert t_chaos.current_chaos() is t_chaos.NULL_CHAOS
