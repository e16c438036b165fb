"""``correct`` at a size the CPU holds: the program passes, the control (the
reference computed in int8, in the program's place) fails, and so does a
run with the timed path broken underneath, for each fault the cells can
have.  The harness's look for a chip is skipped; the rest of a run is
driven as on the chip, the program's scan in its plain version."""

import pytest
import torch

from bench import manifest, service
from bench.tests._tiny import run, tiny_cell

CELLS = [w["name"] for w in manifest.load()["workloads"]]


def _half_left_out(d, i, scan):
    """Half of the batch left out: its rows keep the empty window."""
    h = d.shape[0] // 2
    return (torch.cat([d[:h], torch.full_like(d[h:], float("inf"))]),
            torch.cat([i[:h], torch.full_like(i[h:], -1)]), scan)


def _answer_altered(d, i, scan):
    """Each query's nearest id changed where the step produces it."""
    i = i.clone()
    i[:, 0] = (i[:, 0] + 1) % 8192
    return d, i, scan


def _state_unchanged(d, i, scan):
    """The step returns the window it started from."""
    return torch.full_like(d, float("inf")), torch.full_like(i, -1), scan


FAULTS = {"half_left_out": _half_left_out, "answer_altered": _answer_altered,
          "state_unchanged": _state_unchanged}


@pytest.mark.parametrize("cell", CELLS)
def test_bench_program_is_correct(cell):
    result, checks = run(tiny_cell(cell))
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_bench_control_is_not_correct(cell):
    result, checks = run(tiny_cell(cell), control=True)
    assert not result["correct"], checks
    # it fails on what it computes, not on an answer lost
    assert any(checks[n]["value"] > checks[n]["limit"] for n in ("gap", "dist_err")), checks


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["deep1m.batch", "deep1m.online"])
def test_bench_broken_step_is_not_correct(monkeypatch, cell, fault):
    real = service.build_search_step

    def broken(svc, **kw):
        step = real(svc, **kw)
        return lambda *a: FAULTS[fault](*step(*a))

    monkeypatch.setattr(service, "build_search_step", broken)
    result, checks = run(tiny_cell(cell))
    assert not result["correct"], checks
