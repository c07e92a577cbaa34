"""The frozen plain reference (reference/rt) against the port's plain path
at 64 x 72 on the CPU: the RRTMG and RRTMGP refreshes and an update. The
test imports the port; the reference does not."""

import subprocess
import sys

import pytest
import torch

import scene
from reference.compare import Reference

N, NLEV = 64, 72


def port_refresh(config, arrays, doy, utc):
    from geosradiation_gridcomp_tpu_torch.driver.step import \
        radiation_refresh
    import program
    cfg = program.port_config(config)
    ict, icb = program.superlayers(cfg, arrays)
    return cfg, radiation_refresh(program.port_inputs(arrays, "cpu"), doy,
                                  utc, config=cfg, ict=ict, icb=icb,
                                  plain=True)


def assert_states_equal(got, want):
    for g, w in zip(got, want):
        for f in g._fields:
            torch.testing.assert_close(getattr(g, f), getattr(w, f),
                                       rtol=0, atol=0, msg=f)


@pytest.mark.parametrize("name", ["rrtmg_l72", "rrtmgp_l72"])
def test_reference_refresh_equals_the_ports_plain_path(name):
    import harness
    torch.set_num_threads(1)
    cfg = harness.read_json(f"{harness.HERE}/configs/{name}.json")
    arrays = scene.scene(N, NLEV, 7)
    ref = Reference(cfg, arrays, "cpu", 40)
    _, want = port_refresh(cfg, arrays, 172.25, 6.0)
    assert_states_equal(ref.refresh(172.25, 6.0, None), want)


def test_reference_packing_and_update_equal_the_ports():
    """The daylight packing worked out again (the kept columns, zeros
    elsewhere) and an update from the reference's own states."""
    import harness
    import program
    from geosradiation_gridcomp_tpu_torch.driver.step import (
        radiation_refresh, radiation_update, sw_partition_bounds)
    torch.set_num_threads(1)
    cfg = harness.read_json(f"{harness.HERE}/configs/rrtmg_l72.json")
    arrays = scene.scene(N, NLEV, 8)
    pcfg = program.port_config(cfg)
    inp = program.port_inputs(arrays, "cpu")
    ict, icb = program.superlayers(pcfg, arrays)
    sched = program.day_schedule(172.0, 24, 5)
    bounds = [sw_partition_bounds(inp.lons, inp.lats, inp.fcld, d, u, pcfg,
                                  8) for d, u in sched]
    nlit = max(b[0] for b in bounds)
    ref = Reference(cfg, arrays, "cpu", 24)
    assert ref.packing(sched, 8) == nlit
    states = radiation_refresh(inp, *sched[3], config=pcfg, ict=ict,
                               icb=icb, sw_nlit=nlit, plain=True)
    mine = ref.refresh(*sched[3], nlit)
    assert_states_equal(mine, states)
    ts = inp.tsinst + 0.7
    up = radiation_update(*states, ts, inp.lons, inp.lats, inp.ple,
                          172.3, 7.25, config=pcfg)
    rup = ref.update(*mine, ts.clone(), 172.3, 7.25)
    for group in ("sw", "lw"):
        for k in up[group]:
            torch.testing.assert_close(rup[group][k], up[group][k], rtol=0,
                                       atol=0)
    for k in ("dtdt", "alw", "blw"):
        torch.testing.assert_close(rup[k], up[k], rtol=0, atol=0)


def test_the_reference_imports_nothing_of_the_port_or_jax():
    code = ("import sys; sys.path.insert(0, %r); import reference.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (__import__("harness").HERE,))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    top = eval(out)
    assert not set(top) & {"jax", "jaxlib", "flax",
                           "geosradiation_gridcomp_tpu",
                           "geosradiation_gridcomp_tpu_torch"}


def test_the_control_rounds_through_bfloat16():
    import harness
    torch.set_num_threads(1)
    cfg = harness.read_json(f"{harness.HERE}/configs/rrtmg_l72.json")
    arrays = scene.scene(16, NLEV, 9)
    ctrl = Reference(cfg, arrays, "cpu", 16, control=True)
    sol, irr = ctrl.refresh(172.5, 12.0, None)
    for x in (*sol, *irr):
        assert torch.equal(x, x.to(torch.bfloat16).float())
    assert torch.equal(ctrl.inp.t, torch.as_tensor(arrays["t"]))
    want = Reference(cfg, arrays, "cpu", 16).refresh(172.5, 12.0, None)
    for x, w in zip((*sol, *irr), (*want[0], *want[1])):
        assert torch.equal(x, w.to(torch.bfloat16).float())
