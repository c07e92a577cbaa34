"""The port's SOLAR driver and the combined SW+LW step against the JAX CPU
oracle on the realistic scene (8 columns x 72 levels, doy 172, 12 UTC):
radiation_refresh + radiation_update under the default config with the
daylight packing of sw_partition_bounds (4 lit columns, 3 of them cloudy:
both the nlit slice and the ncld split engage), and under aerosol with
the no-aerosol second pass and no packing.

Gates (relmax = max|a-b| / max|b|, tools/verify_tpu.py:33-36): every
SolarState and IrradState field and every export <= 5e-5. The heating
rates are differences of adjacent level fluxes over dp, which amplifies
the fluxes' ~1.5e-6 roundoff: below 100 hPa they agree to 6.4e-5
(measured), gated at 2e-4, under the reference's own 5e-4. In the
reference's form (tests/test_accuracy.py:142-152) every layer's
flux-divergence error |d dtdt| x dp, the few-Pa layers near the model top
included, and the relative rate where dp > 100 Pa are held within the
bounds the 5e-5 flux gates imply (see test_heating_rates_reference_form;
measured 5.4e-6 and 6.1e-6 K/s Pa against bounds of 6.4e-4 and 6.9e-4).
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.config import RadiationConfig, Scheme
from geosradiation_gridcomp_tpu.driver import astronomy as jast
from geosradiation_gridcomp_tpu.driver import step as jstep
from geosradiation_gridcomp_tpu_torch.config import RadiationConfig as TConfig
from geosradiation_gridcomp_tpu_torch.constants import CP, GRAV
from geosradiation_gridcomp_tpu_torch.config import Scheme as TScheme
from geosradiation_gridcomp_tpu_torch.driver import astronomy as tast
from geosradiation_gridcomp_tpu_torch.driver import radiation as trad
from geosradiation_gridcomp_tpu_torch.driver import step as tstep
from geosradiation_gridcomp_tpu_torch.driver.state import (IrradState,
                                                           SolarState)
from geosradiation_gridcomp_tpu_torch.models.rrtmg.lw import RRTMGLW
from geosradiation_gridcomp_tpu_torch.models.rrtmg.sw import RRTMGSW
from geosradiation_gridcomp_tpu_torch.scene import example_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from __graft_entry__ import _example_inputs  # noqa: E402

torch.set_num_threads(1)

NCOL, NLEV, DOY, UTC = 8, 72, 172.0, 12.0
CFG = RadiationConfig()
CFG_NA = RadiationConfig(outputs=frozenset(
    {"olrb", "tbrb", "band_sfc", "clear_counts", "no_aerosol"}))
T_CFG = TConfig()


def port_config(c):
    """The port's RadiationConfig with the fields of the reference's c."""
    return TConfig(**{f.name: TScheme(v.value) if isinstance(v, Scheme)
                      else v for f in dataclasses.fields(c)
                      for v in (getattr(c, f.name),)})


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
def runs():
    """(oracle, port) refresh states and updates of both runs."""
    ji = _example_inputs(NCOL, NLEV)
    ti = example_inputs(NCOL, NLEV, device="cpu")
    pmid = 0.5 * (np.asarray(ji.ple)[0, 1:] + np.asarray(ji.ple)[0, :-1])
    ict, icb = CFG.superlayer_indices(pmid)
    bounds = tstep.sw_partition_bounds(ti.lons, ti.lats, ti.fcld, DOY, UTC,
                                       T_CFG, bucket=1)
    mods = dict(sw=RRTMGSW.from_reference_tables("cpu"),
                lw=RRTMGLW.from_reference_tables("cpu"))
    sw_aero, lw_aero = _aerosol()
    out = {}
    for name, cfg, kw in (
            ("packed", CFG, dict(sw_nlit=bounds[0], sw_ncld=bounds[1])),
            ("aerosol", CFG_NA, dict(sw_aero=sw_aero, lw_aero=lw_aero))):
        jkw = {k: (tuple(jnp.asarray(x) for x in v) if k == "sw_aero"
                   else jnp.asarray(v) if k == "lw_aero" else v)
               for k, v in kw.items()}
        tkw = {k: (tuple(torch.as_tensor(x) for x in v) if k == "sw_aero"
                   else torch.as_tensor(v) if k == "lw_aero" else v)
               for k, v in kw.items()}
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
    return ji, ti, bounds, out


def test_partition_bounds(runs):
    ji, ti, bounds, _ = runs
    assert bounds == (4, 3)
    for bucket in (1, 2, 256):
        for utc in (0.0, 12.0):
            assert tstep.sw_partition_bounds(
                ti.lons, ti.lats, ti.fcld, DOY, utc, T_CFG, bucket=bucket) \
                == jstep.sw_partition_bounds(
                    ji.lons, ji.lats, ji.fcld, DOY, utc, CFG, bucket=bucket)
            assert tstep.lit_column_bound(ti.lons, ti.lats, DOY, utc, T_CFG,
                                          bucket=bucket) \
                == jstep.lit_column_bound(ji.lons, ji.lats, DOY, utc, CFG,
                                          bucket=bucket)


def test_astronomy():
    lons = np.linspace(0.0, 6.0, 16).astype(np.float32)
    lats = np.linspace(-1.2, 1.2, 16).astype(np.float32)
    tl, tt = torch.as_tensor(lons), torch.as_tensor(lats)
    for doy, utc in ((172.0, 12.0), (1.5, 3.25), (300.0, 23.0)):
        a = tast.mean_cos_zenith(tl, tt, doy, utc, 1.0)
        b = jast.mean_cos_zenith(jnp.asarray(lons), jnp.asarray(lats),
                                 jnp.float32(doy), jnp.float32(utc), 1.0)
        assert relmax(a[0], b[0]) <= 1e-6
        np.testing.assert_array_equal(a[1].numpy(), np.asarray(b[1]))
        d = torch.tensor(doy)
        assert relmax(tast.earth_sun_factor(d),
                      jast.earth_sun_factor(jnp.float32(doy))) <= 1e-6


@pytest.mark.parametrize("run", ["packed", "aerosol"])
@pytest.mark.parametrize("field", SolarState._fields)
def test_solar_state(runs, run, field):
    js, ts, _ = runs[3][run]
    a, b = getattr(ts[0], field), np.asarray(getattr(js[0], field))
    assert tuple(a.shape) == b.shape
    assert relmax(a.numpy(), b) <= 5e-5


@pytest.mark.parametrize("run", ["packed", "aerosol"])
def test_irrad_state(runs, run):
    js, ts, _ = runs[3][run]
    for f in IrradState._fields:
        assert relmax(getattr(ts[1], f).numpy(),
                      np.asarray(getattr(js[1], f))) <= 5e-5, f


@pytest.mark.parametrize("run", ["packed", "aerosol"])
def test_radiation_update(runs, run):
    ji, ti, _, out = runs
    _, _, (ju, tu) = out[run]
    assert set(tu) == set(ju)
    for group in ("sw", "lw"):
        assert set(tu[group]) == set(ju[group])
        for k in ju[group]:
            assert relmax(tu[group][k].numpy(),
                          np.asarray(ju[group][k])) <= 5e-5, (group, k)
    for k in ("alw", "blw"):
        assert relmax(tu[k].numpy(), np.asarray(ju[k])) <= 5e-5, k
    play = 0.5 * (ti.ple[:, 1:] + ti.ple[:, :-1])
    low = (play > 1.0e4).numpy()
    assert torch.isfinite(tu["dtdt"]).all()
    assert relmax(tu["dtdt"].numpy()[low], np.asarray(ju["dtdt"])[low]) \
        <= 2e-4


@pytest.mark.parametrize("run", ["packed", "aerosol"])
def test_heating_rates_reference_form(runs, run):
    """dtdt = GRAV / (CP dp) times the SW+LW net flux difference across a
    layer, so |error| x dp is GRAV / CP times the error of two flux
    differences: with fsw and flw within relmax 5e-5 of the oracle's it is
    at most B = 2 (5e-5 max|fsw| + 5e-5 max|flw|) GRAV / CP in every
    layer; where dp > 100 Pa the rate's error is at most B / 100 Pa, the
    relative bound against the largest rate there."""
    _, ti, _, out = runs
    _, _, (ju, tu) = out[run]
    a = tu["dtdt"].double().numpy()
    b = np.asarray(ju["dtdt"], np.float64)
    ple = ti.ple.double().numpy()
    dp = ple[:, 1:] - ple[:, :-1]
    div = 2.0 * 5e-5 * (np.abs(np.asarray(ju["sw"]["fsw"])).max()
                        + np.abs(np.asarray(ju["lw"]["flw"])).max()) \
        * GRAV / CP
    err = np.abs(a - b)
    assert (err * dp).max() <= div
    deep = dp > 100.0
    top = np.abs(b[deep]).max()
    assert deep.sum() >= NCOL * 20
    assert err[deep].max() / top <= div / (100.0 * top)


def test_packing_zeroes_night_columns(runs):
    _, ti, _, out = runs
    st = out["packed"][1][0]
    _, lit = tast.mean_cos_zenith(ti.lons, ti.lats, DOY, UTC, 1.0)
    night = lit == 0.0
    assert 0 < int(night.sum()) < NCOL
    assert float(st.flxn[night].abs().max()) == 0.0
    assert float(st.cldfrc[night].abs().max()) == 0.0
    assert float(st.flxn[~night].abs().max()) > 0.1


def test_no_aerosol_pass(runs):
    st = runs[3]["aerosol"][1][0]
    assert relmax(st.flxnan.numpy(), st.flxn.numpy()) > 1e-4
    st_packed = runs[3]["packed"][1][0]
    assert torch.equal(st_packed.flxnan, st_packed.flxn)


def test_physical_fluxes(runs):
    ji, ti, _, out = runs
    ts, (_, tu) = out["packed"][1], out["packed"][2]
    sol = ts[0]
    # net SW into the column never exceeds the TOA insolation (normalized)
    assert float(sol.flxn.max()) <= 1.0
    assert float(sol.flxn[:, -1].min()) >= 0.0
    olr = tu["lw"]["olr"]
    assert float(olr.min()) > 150.0 and float(olr.max()) < 350.0
    play = 0.5 * (ti.ple[:, 1:] + ti.ple[:, :-1])
    hr = tu["dtdt"] * 86400.0
    assert float(hr[play > 1.0e4].abs().max()) < 50.0
    assert all(torch.isfinite(x).all() for x in (*ts[0], *ts[1]))


@pytest.mark.parametrize("scheme", [TScheme.CHOU, TScheme.RRTMGP])
def test_unported_sw_schemes_raise(scheme):
    ti = example_inputs(2, 10, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trad.solar_refresh(ti, torch.full((2,), 0.5), DOY,
                           TConfig(sw_scheme=scheme), 3, 6)
