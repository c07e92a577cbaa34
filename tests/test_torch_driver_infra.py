"""The port's driver infrastructure against the reference's: the clock,
input validation and check_finite (same results, same exception types and
messages), checkpoints (round trip, restart bitwise on the CPU, and files
interchangeable between the two packages, arrays identical), and the lazy
outputs of tests/test_driver_infra.py:163-199 (without the jaxpr check).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.config import RadiationConfig
from geosradiation_gridcomp_tpu.driver import checkpoint as jck
from geosradiation_gridcomp_tpu.driver import clock as jclock
from geosradiation_gridcomp_tpu.driver import step as jstep
from geosradiation_gridcomp_tpu.driver import validate as jval
from geosradiation_gridcomp_tpu_torch.config import RadiationConfig as TConfig
from geosradiation_gridcomp_tpu_torch.driver import checkpoint as tck
from geosradiation_gridcomp_tpu_torch.driver import diagnostics as tdg
from geosradiation_gridcomp_tpu_torch.driver import step as tstep
from geosradiation_gridcomp_tpu_torch.driver import validate as tval
from geosradiation_gridcomp_tpu_torch.driver.clock import RadiationClock
from geosradiation_gridcomp_tpu_torch.models.rrtmg.lw import RRTMGLW
from geosradiation_gridcomp_tpu_torch.models.rrtmg.sw import RRTMGSW
from geosradiation_gridcomp_tpu_torch.scene import example_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from __graft_entry__ import _example_inputs  # noqa: E402

torch.set_num_threads(1)

NCOL, NLEV = 4, 40


@pytest.fixture(scope="module")
def setup():
    inp = example_inputs(NCOL, NLEV, device="cpu")
    ple = inp.ple[0].numpy()
    ict, icb = TConfig().superlayer_indices(0.5 * (ple[1:] + ple[:-1]))
    mods = dict(sw=RRTMGSW.from_reference_tables("cpu"),
                lw=RRTMGLW.from_reference_tables("cpu"))
    return inp, ict, icb, mods


# ---------------------------------------------------------------- clock

def test_clock_refresh_cadence():
    clk = RadiationClock(run_dt=1800.0, solar_dt=3600.0)
    ref = jclock.RadiationClock(run_dt=1800.0, solar_dt=3600.0)
    assert clk.alarm_ringing() and ref.alarm_ringing()
    acts = [clk.tick() for _ in range(4)]
    assert acts == [["update"], ["refresh", "update"],
                    ["update"], ["refresh", "update"]]
    assert acts == [ref.tick() for _ in range(4)]


def test_clock_called_last_ordering():
    clk = RadiationClock(run_dt=3600.0, solar_dt=3600.0, called_last=True)
    assert clk.tick() == ["update", "refresh"]


def test_clock_rejects_non_multiple():
    for cls in (RadiationClock, jclock.RadiationClock):
        with pytest.raises(ValueError, match="positive multiple"):
            cls(run_dt=1800.0, solar_dt=2500.0)


def test_clock_time_queries_and_state():
    kw = dict(run_dt=1800.0, solar_dt=3600.0, start_doy=100.0,
              start_utc_hours=23.0)
    clk, ref = RadiationClock(**kw), jclock.RadiationClock(**kw)
    for _ in range(4):
        clk.tick()
        ref.tick()
    assert clk.utc_hours == pytest.approx(1.0)
    assert clk.doy == pytest.approx(100.0 + 2.0 / 24.0)
    assert (clk.utc_hours, clk.doy) == (ref.utc_hours, ref.doy)
    assert clk.state_dict() == ref.state_dict()
    assert RadiationClock.from_state_dict(clk.state_dict()) == clk


# ----------------------------------------------------------- validation

def _message(fn, inp, exc):
    with pytest.raises(exc) as info:
        fn(inp)
    return str(info.value)


def test_validate_accepts_good_inputs(setup):
    tval.validate_inputs(setup[0])


def test_validate_rejects_garbage_as_the_reference():
    """Same exception type and message as the reference's for each bad
    input: out of range, non-finite, pressures not increasing."""
    ji = _example_inputs(NCOL, NLEV)
    ti = example_inputs(NCOL, NLEV, device="cpu")
    ple = ti.ple.clone()
    ple[:, 3] = ple[:, 2] - 1.0
    cases = [("t", ti.t * 0.0 + 500.0), ("qv", ti.qv * float("nan")),
             ("emis", ti.emis + 0.5), ("co2", -ti.co2), ("ple", ple)]
    for field, bad in cases:
        msg = _message(tval.validate_inputs, ti._replace(**{field: bad}),
                       ValueError)
        ref = _message(jval.validate_inputs,
                       ji._replace(**{field: jnp.asarray(bad.numpy())}),
                       ValueError)
        assert msg == ref, field
        assert msg.startswith("AtmosInputs." + field), msg


def test_check_finite_catches_nan(setup):
    inp, ict, icb, mods = setup
    sol, irr = tstep.radiation_refresh(inp, 172.0, 12.0, config=TConfig(),
                                       ict=ict, icb=icb, **mods)
    assert tval.check_finite(sol, "SolarState") is sol
    poisoned = irr._replace(flx=irr.flx * float("nan"))
    with pytest.raises(FloatingPointError, match="flx") as info:
        tval.check_finite(poisoned, "IrradState")
    with pytest.raises(FloatingPointError) as ref:
        jval.check_finite(poisoned._replace(
            **{f: v.numpy() for f, v in poisoned._asdict().items()}),
            "IrradState")
    assert str(info.value) == str(ref.value) == \
        "IrradState.flx: non-finite values after refresh"


def test_check_finite_names_nested_paths_as_the_reference(setup):
    """Dicts (keys in sorted order), lists and NamedTuples inside them:
    the same path in the message as the reference's keystr."""
    inp, ict, icb, mods = setup
    sol, irr = tstep.radiation_refresh(inp, 172.0, 12.0, config=TConfig(),
                                       ict=ict, icb=icb, **mods)
    upd = tstep.radiation_update(sol, irr, inp.tsinst, inp.lons, inp.lats,
                                 inp.ple, 172.0, 12.0, config=TConfig())
    bad_lw = dict(upd, lw=dict(upd["lw"], olr=upd["lw"]["olr"] * 0.0 / 0.0))
    bad_list = dict(upd, extra=[irr, irr._replace(sfcem=irr.sfcem / 0.0)])
    as_np = lambda x: x.numpy() if isinstance(x, torch.Tensor) else x
    for tree, where in ((bad_lw, "['lw']['olr']"),
                        (bad_list, "['extra'][1].sfcem")):
        with pytest.raises(FloatingPointError) as info:
            tval.check_finite(tree, "update")
        with pytest.raises(FloatingPointError) as ref:
            jval.check_finite(jax.tree_util.tree_map(as_np, tree), "update")
        assert str(info.value) == str(ref.value) == \
            f"update{where}: non-finite values after refresh"
    # integer leaves and None are not checked
    assert tval.check_finite(dict(upd, ints=torch.arange(3), none=None))


# ----------------------------------------------------------- checkpoint

def _run_sequence(inp, ict, icb, mods, clk, nsteps, sol, irr):
    cfg = TConfig()
    outs = []
    for _ in range(nsteps):
        for act in clk.tick():
            if act == "refresh":
                sol, irr = tstep.radiation_refresh(
                    inp, clk.doy, clk.utc_hours, config=cfg, ict=ict,
                    icb=icb, **mods)
            else:
                outs.append(tstep.radiation_update(
                    sol, irr, inp.tsinst, inp.lons, inp.lats, inp.ple,
                    clk.doy, clk.utc_hours, config=cfg))
    return sol, irr, outs


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def test_checkpoint_restart_bitwise(setup, tmp_path):
    """Stop/restart mid-interval reproduces the uninterrupted run exactly
    (tests/test_driver_infra.py:68-106)."""
    inp, ict, icb, mods = setup
    cfg = TConfig()

    def start():
        clk = RadiationClock(run_dt=1800.0, solar_dt=3600.0)
        sol, irr = tstep.radiation_refresh(inp, clk.doy, clk.utc_hours,
                                           config=cfg, ict=ict, icb=icb,
                                           **mods)
        return clk, sol, irr

    clk, sol, irr = start()
    _, _, outs_ref = _run_sequence(inp, ict, icb, mods, clk, 4, sol, irr)

    clk, sol, irr = start()
    sol, irr, outs_a = _run_sequence(inp, ict, icb, mods, clk, 2, sol, irr)
    path = os.fspath(tmp_path / "rad_checkpoint.npz")
    tck.save_checkpoint(path, solar=sol, irrad=irr, clock=clk)
    ck = tck.load_checkpoint(path, device="cpu")
    assert ck["clock"].time_s == clk.time_s
    _, _, outs_b = _run_sequence(inp, ict, icb, mods, ck["clock"], 2,
                                 ck["solar"], ck["irrad"])
    outs = outs_a + outs_b
    assert len(outs) == len(outs_ref) == 4
    for a, b in zip(outs, outs_ref):
        fa, fb = list(_flat(a)), list(_flat(b))
        assert [p for p, _ in fa] == [p for p, _ in fb]
        for (p, x), (_, y) in zip(fa, fb):
            assert torch.equal(x, y), p


def test_checkpoint_roundtrip_fields(setup, tmp_path):
    inp, ict, icb, mods = setup
    sol, irr = tstep.radiation_refresh(inp, 172.0, 12.0, config=TConfig(),
                                       ict=ict, icb=icb, **mods)
    rats = tdg.rats_refresh(inp, 172.0, TConfig(), ict, icb,
                            gases=("CO2", "CH4"), lw=mods["lw"])
    path = os.fspath(tmp_path / "ck.npz")
    tck.save_checkpoint(path, solar=sol, irrad=irr, rats=rats,
                        extra={"note": "test"})
    assert os.listdir(tmp_path) == ["ck.npz"]
    ck = tck.load_checkpoint(path, device="cpu")
    assert ck["extra"] == {"note": "test"} and "clock" not in ck
    for name, tree in (("solar", sol), ("irrad", irr), ("rats", rats)):
        assert type(ck[name]) is type(tree)
        for f in tree._fields:
            assert torch.equal(getattr(ck[name], f), getattr(tree, f)), f


def test_load_checkpoint_defaults_to_the_card(setup, tmp_path):
    """Without a device the states land on the card: on a torch without
    CUDA that raises rather than fall back to the CPU."""
    inp, ict, icb, mods = setup
    sol, irr = tstep.radiation_refresh(inp, 172.0, 12.0, config=TConfig(),
                                       ict=ict, icb=icb, **mods)
    path = os.fspath(tmp_path / "ck.npz")
    tck.save_checkpoint(path, irrad=irr)
    if torch.cuda.is_available():
        assert tck.load_checkpoint(path)["irrad"].flx.device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        tck.load_checkpoint(path)


@pytest.fixture(scope="module")
def jax_states():
    ji = _example_inputs(NCOL, NLEV)
    cfg = RadiationConfig()
    pmid = 0.5 * (np.asarray(ji.ple)[0, 1:] + np.asarray(ji.ple)[0, :-1])
    ict, icb = cfg.superlayer_indices(pmid)
    return jstep.radiation_refresh(ji, 172.0, 12.0, config=cfg, ict=ict,
                                   icb=icb)


def test_reference_checkpoint_loads_in_the_port(jax_states, tmp_path):
    sol, irr = jax_states
    clk = jclock.RadiationClock(run_dt=1800.0, solar_dt=3600.0)
    clk.tick()
    path = os.fspath(tmp_path / "ref.npz")
    jck.save_checkpoint(path, solar=sol, irrad=irr, clock=clk,
                        extra={"by": "reference"})
    ck = tck.load_checkpoint(path, device="cpu")
    assert ck["extra"] == {"by": "reference"}
    assert ck["clock"].state_dict() == clk.state_dict()
    for name, tree in (("solar", sol), ("irrad", irr)):
        for f in tree._fields:
            a, b = getattr(ck[name], f).numpy(), np.asarray(getattr(tree, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_port_checkpoint_loads_in_the_reference(setup, tmp_path):
    inp, ict, icb, mods = setup
    sol, irr = tstep.radiation_refresh(inp, 172.0, 12.0, config=TConfig(),
                                       ict=ict, icb=icb, **mods)
    rats = tdg.rats_refresh(inp, 172.0, TConfig(), ict, icb, gases=("O3",),
                            lw=mods["lw"])
    clk = RadiationClock(run_dt=900.0, solar_dt=3600.0, start_doy=3.0)
    clk.tick()
    path = os.fspath(tmp_path / "port.npz")
    tck.save_checkpoint(path, solar=sol, irrad=irr, rats=rats, clock=clk)
    ck = jck.load_checkpoint(path)
    assert ck["clock"].state_dict() == clk.state_dict()
    for name, tree in (("solar", sol), ("irrad", irr), ("rats", rats)):
        assert type(ck[name]).__name__ == type(tree).__name__
        for f in tree._fields:
            a, b = np.asarray(getattr(ck[name], f)), getattr(tree, f).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------- lazy diagnostics

def test_lazy_diagnostics_prune_update(setup):
    inp, ict, icb, mods = setup
    full, lean = TConfig(), TConfig(outputs=frozenset())
    sol, irr = tstep.radiation_refresh(inp, 172.0, 12.0, config=full,
                                       ict=ict, icb=icb, **mods)
    args = (sol, irr, inp.tsinst, inp.lons, inp.lats, inp.ple, 172.0, 12.0)
    out_full = tstep.radiation_update(*args, config=full)
    assert "tbrb" in out_full["lw"] and "olrb" in out_full["lw"]
    assert "flx_sfc_band" in out_full["sw"]
    out_lean = tstep.radiation_update(*args, config=lean)
    assert "tbrb" not in out_lean["lw"] and "olrb" not in out_lean["lw"]
    assert "flx_sfc_band" not in out_lean["sw"]


def test_lazy_diagnostics_prune_refresh(setup):
    inp, ict, icb, mods = setup
    sol, irr = tstep.radiation_refresh(
        inp, 172.0, 12.0, config=TConfig(outputs=frozenset()), ict=ict,
        icb=icb, **mods)
    assert bool((irr.olrb == 0.0).all())
    assert bool((irr.dolrb_dts == 0.0).all())
    assert bool(torch.isfinite(irr.flx).all())
    assert bool(torch.isfinite(sol.flxn).all())
