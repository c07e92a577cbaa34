"""The comparison that decides `correct` fails what it must: the control
(the reference in bfloat16) reads beyond every cell's limits, and a run
whose timed path is broken underneath comes out not correct, for each
fault a cell can have (one card: no exchange between cards to leave
out). On the CPU at 64 columns; the card test repeats the control at
1024 columns on the card."""

from types import SimpleNamespace

import pytest

import harness
from conftest import CELLS, small_copy


def exceeds(reading, limits):
    return any(not reading[k] <= limits[k] for k in limits)


def within(reading, limits):
    return all(reading[k] <= limits[k] for k in limits)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_port_passes(cell, small):
    import control
    c = harness.load_cell(cell, small)
    port, ctrl = control.readings(c, 2**31 + 21, 1.0, device="cpu")
    assert within(port, c.workload["limits"])
    assert exceeds(ctrl, c.workload["limits"])


def _stale(fn):
    """A step that returns its state unchanged: each call answers with
    the previous call's outputs."""
    last = []

    def wrapper(*a, **k):
        out = fn(*a, **k)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return wrapper


def _map(out, f):
    if isinstance(out, dict):
        return {k: _map(v, f) for k, v in out.items()}
    if isinstance(out, tuple):
        vals = [_map(v, f) for v in out]
        return type(out)(*vals) if hasattr(out, "_fields") else tuple(vals)
    return f(out)


def _half(fn):
    """Half of the batch left out: the first half of the columns takes
    the mean of the rest."""
    def cut(x):
        if x.dim() == 0 or not x.is_floating_point():
            return x
        n = x.shape[0] // 2
        x = x.clone()
        x[:n] = x[n:].mean(dim=0)
        return x
    return lambda *a, **k: _map(fn(*a, **k), cut)


def _altered(fn):
    """One answer altered where it is produced: column 3's outputs off by
    one per cent."""
    def alter(x):
        if x.dim() == 0 or not x.is_floating_point():
            return x
        x = x.clone()
        x[3] = x[3] * 1.01
        return x
    return lambda *a, **k: _map(fn(*a, **k), alter)


FAULTS = {"stale": _stale, "half": _half, "altered": _altered}
CASES = [(cell, entry, fault) for cell in CELLS for fault in FAULTS
         for entry in (("radiation_refresh", "radiation_update")
                       if "heartbeat" in cell else ("radiation_refresh",))]


@pytest.mark.parametrize("cell,entry,fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, entry, fault, small,
                                            monkeypatch):
    from geosradiation_gridcomp_tpu_torch.driver import step
    import run
    monkeypatch.setattr(step, entry, FAULTS[fault](getattr(step, entry)))
    out = run.run(SimpleNamespace(workload=cell, seed=2**31 + 31,
                                  seconds=1.5, trace=0), device="cpu",
                  root=small)
    assert out["correct"] is False and out["failed"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_card_control_fails_the_port_passes(cell, card, tmp_path):
    import control
    root = small_copy(tmp_path, columns=1024, block=1024)
    c = harness.load_cell(cell, root)
    port, ctrl = control.readings(c, 2**31 + 41, 2.0, device=card)
    assert within(port, c.workload["limits"])
    assert exceeds(ctrl, c.workload["limits"])
