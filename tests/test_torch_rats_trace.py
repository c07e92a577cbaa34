"""The port's RATS ranges and counters (driver/diagnostics.py) on the
CPU at 16 x 72: "rats_refresh/<gas>", "rats_refresh/stack" and
"rats_update" are profiler ranges only while a profiler records; counts()
rises by the calls, solves, zero fills and stacked copies made; and the
outputs are bitwise those of the loop the ranges wrap, profiled or
not."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from geosradiation_gridcomp_tpu_torch.config import RadiationConfig
from geosradiation_gridcomp_tpu_torch.driver import diagnostics as dg
from geosradiation_gridcomp_tpu_torch.driver.diagnostics import (
    RATS_GASES, counts, rats_refresh, rats_update)
from geosradiation_gridcomp_tpu_torch.driver.radiation import irrad_refresh
from geosradiation_gridcomp_tpu_torch.driver.state import RatsState
from geosradiation_gridcomp_tpu_torch.models.rrtmg.lw import RRTMGLW
from geosradiation_gridcomp_tpu_torch.scene import example_inputs

NCOL, NLEV, DOY = 16, 72, 172.0
RANGES = {f"rats_refresh/{g}" for g in RATS_GASES} | {
    "rats_refresh/stack", "rats_update"}


@pytest.fixture(scope="module")
def case():
    torch.set_num_threads(1)
    inp = example_inputs(NCOL, NLEV, device="cpu")
    lw = RRTMGLW.from_reference_tables("cpu")
    cfg = RadiationConfig()
    irr = irrad_refresh(inp, DOY, cfg, 69, 71, lw=lw)
    # the RATS loop as it stood before its ranges and counters
    states = [irrad_refresh(inp._replace(**{f: torch.zeros_like(
        getattr(inp, f))}), DOY, cfg, 69, 71, lw=lw)
        for f in ("qv", "o3", "co2", "ch4", "n2o", "cfc11", "cfc12",
                  "hcfc22")]
    before = RatsState(*(torch.stack([getattr(s, f) for s in states])
                         for f in RatsState._fields))
    return dict(inp=inp, lw=lw, cfg=cfg, irr=irr, before=before)


def _call(case):
    rats = rats_refresh(case["inp"], DOY, case["cfg"], 69, 71,
                        lw=case["lw"])
    return rats, rats_update(rats, case["irr"], case["inp"].tsinst + 0.4)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_ranges_only_under_a_profiler(case, monkeypatch):
    opened = []
    record = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return record(name, *args)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    plain = _call(case)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _call(case)
    assert set(opened) == RANGES and len(opened) == len(RANGES)
    assert RANGES <= {e.name for e in prof.events()}
    assert _equal(traced[0], plain[0]) and _equal(traced[1], plain[1])


def test_outputs_bitwise_as_before(case):
    rats, (flx_rat, forcing) = _call(case)
    assert _equal(rats, case["before"])
    irr, ts = case["irr"], case["inp"].tsinst + 0.4
    delt = (ts - irr.ts)[None, :, None]
    assert torch.equal(flx_rat, rats.flx + rats.dfdts * delt)
    all_ = (irr.flx + irr.dfdts * (ts - irr.ts)[:, None])[None]
    assert torch.equal(forcing, all_ - flx_rat)


def test_counts_after_two_refreshes(case):
    before = counts()
    _call(case)
    _call(case)
    after = counts()
    diff = {name: {k: after[name][k] - before[name][k] for k in c}
            for name, c in after.items()}
    assert diff == {
        "rats_refresh": dict(calls=2, solves=16, fills=16, copies=80),
        "rats_update": dict(calls=2, fills=0, copies=0)}


def test_counts_follow_the_gases_asked_for(case):
    before = counts()["rats_refresh"]
    rats_refresh(case["inp"], DOY, case["cfg"], 69, 71, lw=case["lw"],
                 gases=("CO2", "CH4"))
    after = counts()["rats_refresh"]
    assert {k: after[k] - before[k] for k in after} == dict(
        calls=1, solves=2, fills=2, copies=10)
    # a copy: changing it changes nothing of the port's
    counts()["rats_refresh"]["calls"] += 100
    assert counts()["rats_refresh"] == after
    assert dg._COUNTS["rats_refresh"] == after
