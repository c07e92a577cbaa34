"""The port's driver under Scheme.RRTMGP against the JAX CPU oracle:
radiation_refresh + radiation_update on the realistic scene (8 columns x
72 levels, doy 172, 12 UTC) through the RRTMG-reduced facade (default
outputs; and with SW and LW aerosol and the no-aerosol second pass) and
through the native engine (the synthetic coefficient set of
tests/test_rrtmgp_engine.py written as npz files, as
tests/test_rrtmgp_driver.py:10-31 does).

Gates (relmax = max|a-b| / max|b|): every SolarState and IrradState field
and every export <= 5e-5, the UNDEF fills at the same places; the heating
rates below 100 hPa <= 2e-4 (tests/test_torch_solar.py states why). One
exception: without aerosol the clear-sky upward SW (flcun, its export
fscu) <= 1e-4, the facade rte_sw's clear-sky upward flux, which the
oracle does not reproduce itself within 5e-5 (jitted against op by op;
tests/test_torch_rrtmgp.py:test_rte_sw_oracle_floor). Measured: flcun
4.0e-5, fscu 5.3e-5.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.config import RadiationConfig, Scheme
from geosradiation_gridcomp_tpu.driver import step as jstep
from geosradiation_gridcomp_tpu_torch.driver import step as tstep
from geosradiation_gridcomp_tpu_torch.driver.diagnostics import UNDEF
from geosradiation_gridcomp_tpu_torch.driver.state import (IrradState,
                                                           SolarState)
from geosradiation_gridcomp_tpu_torch.models.rrtmg.lw import RRTMGLW
from geosradiation_gridcomp_tpu_torch.models.rrtmg.sw import RRTMGSW
from geosradiation_gridcomp_tpu_torch.scene import example_inputs
from tests.test_rrtmgp_driver import _save_kdist_npz
from tests.test_rrtmgp_engine import make_kdist
from tests.test_torch_solar import port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from __graft_entry__ import _example_inputs  # noqa: E402

torch.set_num_threads(1)

NCOL, NLEV, DOY, UTC = 8, 72, 172.0, 12.0
RUNS = ("facade", "aerosol", "native")


def relmax(a, b, floor=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


def _aerosol():
    rng = np.random.default_rng(9)
    u = lambda lo, hi, nb: rng.uniform(lo, hi, (NCOL, NLEV, nb)).astype(
        np.float32)
    return (u(0.0, 0.05, 14), u(0.8, 1.0, 14), u(0.5, 0.8, 14)), \
        u(0.0, 0.05, 16)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("kdist")
    lw_path, sw_path = str(d / "lw.npz"), str(d / "sw.npz")
    for p in (lw_path, sw_path):
        _save_kdist_npz(make_kdist(), p)
    rrtmgp = dict(sw_scheme=Scheme.RRTMGP, lw_scheme=Scheme.RRTMGP)
    sw_aero, lw_aero = _aerosol()
    cases = {
        "facade": (RadiationConfig(**rrtmgp), {}),
        "aerosol": (RadiationConfig(**rrtmgp, outputs=frozenset(
            {"olrb", "tbrb", "band_sfc", "no_aerosol"})),
            dict(sw_aero=sw_aero, lw_aero=lw_aero)),
        "native": (RadiationConfig(**rrtmgp, rrtmgp_kdist_lw=lw_path,
                                   rrtmgp_kdist_sw=sw_path,
                                   outputs=frozenset({"olrb"})), {})}
    ji = _example_inputs(NCOL, NLEV)
    ti = example_inputs(NCOL, NLEV, device="cpu")
    pmid = 0.5 * (np.asarray(ji.ple)[0, 1:] + np.asarray(ji.ple)[0, :-1])
    mods = dict(sw=RRTMGSW.from_reference_tables("cpu"),
                lw=RRTMGLW.from_reference_tables("cpu"))
    out = {}
    for name, (cfg, kw) in cases.items():
        ict, icb = cfg.superlayer_indices(pmid)
        jkw = {k: (tuple(jnp.asarray(x) for x in v) if k == "sw_aero"
                   else jnp.asarray(v)) for k, v in kw.items()}
        tkw = {k: (tuple(torch.as_tensor(x) for x in v) if k == "sw_aero"
                   else torch.as_tensor(v)) for k, v in kw.items()}
        js = jstep.radiation_refresh(ji, DOY, UTC, config=cfg, ict=ict,
                                     icb=icb, **jkw)
        ts = tstep.radiation_refresh(ti, DOY, UTC, config=port_config(cfg),
                                     ict=ict, icb=icb, **tkw, **mods)
        upd = [step.radiation_update(*st, inp.tsinst + 0.5, inp.lons,
                                     inp.lats, inp.ple, DOY, UTC + 0.25,
                                     config=c)
               for step, st, inp, c in ((jstep, js, ji, cfg),
                                        (tstep, ts, ti, port_config(cfg)))]
        out[name] = (js, ts, upd)
    return ti, out


def _tol(run, key):
    return 1e-4 if run == "facade" and key in ("flcun", "fscu") else 5e-5


def _same_undef(a, b):
    np.testing.assert_array_equal(a.numpy() >= UNDEF, np.asarray(b) >= UNDEF)


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("field", SolarState._fields)
def test_solar_state(runs, run, field):
    js, ts, _ = runs[1][run]
    a, b = getattr(ts[0], field), np.asarray(getattr(js[0], field))
    assert tuple(a.shape) == b.shape
    _same_undef(a, b)
    assert relmax(a.numpy(), b) <= _tol(run, field)


@pytest.mark.parametrize("run", RUNS)
def test_irrad_state(runs, run):
    js, ts, _ = runs[1][run]
    for f in IrradState._fields:
        a, b = getattr(ts[1], f), np.asarray(getattr(js[1], f))
        assert tuple(a.shape) == b.shape, f
        assert relmax(a.numpy(), b) <= 5e-5, f


@pytest.mark.parametrize("run", RUNS)
def test_radiation_update(runs, run):
    ti, out = runs
    _, _, (ju, tu) = out[run]
    assert set(tu) == set(ju)
    for group in ("sw", "lw"):
        assert set(tu[group]) == set(ju[group])
        for k in ju[group]:
            _same_undef(tu[group][k], ju[group][k])
            assert relmax(tu[group][k].numpy(),
                          np.asarray(ju[group][k])) <= _tol(run, k), \
                (group, k)
    for k in ("alw", "blw"):
        assert relmax(tu[k].numpy(), np.asarray(ju[k])) <= 5e-5, k
    play = 0.5 * (ti.ple[:, 1:] + ti.ple[:, :-1])
    low = (play > 1.0e4).numpy()
    assert torch.isfinite(tu["dtdt"]).all()
    assert relmax(tu["dtdt"].numpy()[low], np.asarray(ju["dtdt"])[low]) \
        <= 2e-4


def test_state_mapping(runs):
    """The RRTMGP SolarState: band fields UNDEF, UV and NIR zero, PAR the
    surface direct and diffuse; no-aerosol fields alias the all-sky ones
    without aerosol and differ with it; the native route's band OLR has
    the native set's 2 bands."""
    _, out = runs
    sol, irr = out["facade"][1]
    for f in ("flx_sfc_band_n", "drband_n", "dfband_n", "cldfrc"):
        assert bool((getattr(sol, f) == UNDEF).all()), f
    for f in ("fdir_uv_n", "fdif_uv_n", "fdir_nir_n", "fdif_nir_n"):
        assert float(getattr(sol, f).abs().max()) == 0.0, f
    assert float(sol.fdir_par_n.max()) > 0.1
    assert torch.equal(sol.flxnan, sol.flxn)
    assert torch.equal(irr.flxa, irr.flx) and torch.equal(irr.dfdtsna,
                                                          irr.dfdts)
    na = out["aerosol"][1][0]
    assert relmax(na.flxnan.numpy(), na.flxn.numpy()) > 1e-4
    assert tuple(out["native"][1][1].olrb.shape) == (NCOL, 2)


def test_physical_fluxes(runs):
    ti, out = runs
    for run in RUNS:
        (sol, irr), (_, tu) = out[run][1], out[run][2]
        assert float(sol.flxn.max()) <= 1.0 + 1e-5
        assert float(sol.flxn[:, -1].min()) >= 0.0
        assert all(torch.isfinite(x).all() for x in (*sol, *irr))
        olr = tu["lw"]["olr"]
        # the synthetic native set's Planck table (10-60 W/m^2 a band)
        # gives ~30 W/m^2
        lo, hi = (20.0, 60.0) if run == "native" else (150.0, 350.0)
        assert float(olr.min()) > lo and float(olr.max()) < hi, run
