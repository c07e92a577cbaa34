"""The port's Chou-Suarez schemes against the JAX CPU oracle, and the
oracle's own physics tests of them run on the port.

Parity, on the realistic scene (8 columns x 72 levels, seed 0), same inputs
on both sides, relmax = max|a-b| / max|b| (tools/verify_tpu.py:33-36),
every output <= 5e-5: the delta-Eddington layer optics `deledd`; the cloud
optics getirtau, getvistau and getnirtau (the oracle's per-column
functions under vmap); chou_sw with and without aerosol; chou_lw with and
without aerosol, with the trace gases on and off; the Chou branches of
radiation_refresh + radiation_update, with and without aerosol (the LW
aerosol a (taua, ssaa, asya) triple), the heating rates in the
reference's form at those gates.

The oracle's float32 arithmetic differs from the port's in the last bit
here and there (XLA's CPU backend fuses a multiply and an add into one
FMA; its exp and log10 round differently), and deledd's closed form
amplifies that near the akk*mu0 = 1 resonance: the SW outputs sit up to
~4e-5 from the oracle, the LW ones ~1e-6. A float64 solve shows both
float32 solves within the gate of it, the port's the closer.

Physics: the cases of tests/test_chou_sw.py, tests/test_chou_lw.py and
tests/test_cross_scheme.py, on the port, with their bounds.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.config import RadiationConfig, Scheme
from geosradiation_gridcomp_tpu.driver import radiation as jrad
from geosradiation_gridcomp_tpu.driver import step as jstep
from geosradiation_gridcomp_tpu.models.chou_lw import chou_lw as j_chou_lw
from geosradiation_gridcomp_tpu.models.chou_sw import chou_sw as j_chou_sw
from geosradiation_gridcomp_tpu.ops import chou_optics as jco
from geosradiation_gridcomp_tpu.ops.twostream import deledd as j_deledd
from geosradiation_gridcomp_tpu_torch.config import RadiationConfig as TConfig
from geosradiation_gridcomp_tpu_torch.config import Scheme as TScheme
from geosradiation_gridcomp_tpu_torch.constants import CP, GRAV
from geosradiation_gridcomp_tpu_torch.driver import radiation as trad
from geosradiation_gridcomp_tpu_torch.driver import step as tstep
from geosradiation_gridcomp_tpu_torch.driver.state import (IrradState,
                                                           SolarState)
from geosradiation_gridcomp_tpu_torch.models import chou_lw as chou_lw_module
from geosradiation_gridcomp_tpu_torch.models.chou_lw import chou_lw
from geosradiation_gridcomp_tpu_torch.models.chou_sw import chou_sw
from geosradiation_gridcomp_tpu_torch.ops import chou_optics as tco
from geosradiation_gridcomp_tpu_torch.ops.twostream import deledd
from geosradiation_gridcomp_tpu_torch.scene import example_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from __graft_entry__ import _example_inputs  # noqa: E402
from tests.profiles import make_profile  # noqa: E402

torch.set_num_threads(1)

NCOL, NLEV, DOY, UTC = 8, 72, 172.0, 12.0
GATE = 5e-5
CHOU = RadiationConfig(sw_scheme=Scheme.CHOU, lw_scheme=Scheme.CHOU)
T_CHOU = TConfig(sw_scheme=TScheme.CHOU, lw_scheme=TScheme.CHOU)


def relmax(a, b, floor=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


def t(x):
    return torch.as_tensor(np.array(x))


def _aerosol(nband, seed):
    """Chou's aerosol triple: optical depth, scattering optical depth
    (tau * ssa) and tau * ssa * g."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, (NCOL, NLEV, nband)).astype(
        np.float32)
    taua = u(0.0, 0.05)
    ssaa = (taua * u(0.8, 1.0)).astype(np.float32)
    asya = (ssaa * u(0.5, 0.8)).astype(np.float32)
    return taua, ssaa, asya


@pytest.fixture(scope="module")
def scene():
    ji = _example_inputs(NCOL, NLEV)
    cwc, reff = (np.asarray(x) for x in jrad._cwc_reff(ji))
    ple = np.asarray(ji.ple)
    pmid = 0.5 * (ple[0, 1:] + ple[0, :-1])
    ict, icb = CHOU.superlayer_indices(pmid)
    arr = {f: np.asarray(getattr(ji, f)) for f in ji._fields}
    cosz = np.clip(np.cos(arr["lats"]), 0.0, 1.0).astype(np.float32)
    return dict(ji=ji, a=arr, cwc=cwc, reff=reff, dp=ple[:, 1:] - ple[:, :-1],
                ict=ict, icb=icb, cosz=cosz)


# ------------------------------------------------------------- layer optics

def test_deledd():
    """Beam (per-element cosine) and diffuse (the 0.602 angle) forms on
    optical depths, albedos and asymmetries of the scene's range."""
    rng = np.random.default_rng(3)
    n = 20000
    tau = (rng.uniform(0.0, 1.0, n) ** 3 * 20.0).astype(np.float32)
    ssc = rng.uniform(0.0, 0.99, n).astype(np.float32)
    g0 = rng.uniform(0.0, 0.85, n).astype(np.float32)
    mu = rng.uniform(0.05, 1.0, n).astype(np.float32)
    jb = jax.jit(j_deledd)(tau, ssc, g0, mu)
    tb = deledd(t(tau), t(ssc), t(g0), t(mu))
    jd = jax.jit(lambda a, b, c: j_deledd(a, b, c, 0.602))(tau, ssc, g0)
    td = deledd(t(tau), t(ssc), t(g0), 0.602)
    for a, b in (*zip(tb, jb), *zip(td, jd)):
        assert relmax(a.numpy(), b) <= GATE


def test_getirtau(scene):
    s = scene
    j = jax.jit(jco.getirtau)(s["dp"], s["a"]["fcld"], s["reff"], s["cwc"])
    p = tco.getirtau(t(s["dp"]), t(s["a"]["fcld"]), t(s["reff"]),
                     t(s["cwc"]))
    for a, b in zip(p, j):
        assert a.shape == b.shape
        assert relmax(a.numpy(), b) <= GATE


@pytest.mark.parametrize("name", ["getvistau", "getnirtau"])
def test_sw_cloud_optics(scene, name):
    s = scene
    fn = getattr(jco, name)
    j = jax.jit(jax.vmap(lambda *a: fn(*a, s["ict"], s["icb"])))(
        s["cosz"], s["dp"], s["a"]["fcld"], s["reff"], s["cwc"])
    p = getattr(tco, name)(t(s["cosz"]), t(s["dp"]), t(s["a"]["fcld"]),
                           t(s["reff"]), t(s["cwc"]), s["ict"], s["icb"])
    for a, b in zip(p, j):
        assert a.shape == b.shape
        assert relmax(a.numpy(), b) <= GATE


# ---------------------------------------------------------------- schemes

def _sw_args(s, aerosol):
    a = s["a"]
    args = (s["cosz"], a["ple"], a["t"], a["qv"], a["o3"], a["co2"],
            s["cwc"], a["fcld"], s["reff"])
    aero = _aerosol(8, 11) if aerosol else (None,) * 3
    kw = dict(rsuvbm=a["albvr"], rsuvdf=a["albvf"], rsirbm=a["albnr"],
              rsirdf=a["albnf"])
    return args, aero, kw


@pytest.fixture(scope="module")
def sw_runs(scene):
    out = {}
    for aerosol in (False, True):
        args, aero, kw = _sw_args(scene, aerosol)
        j = j_chou_sw(*args, *aero, **kw, ict=scene["ict"], icb=scene["icb"])
        p = chou_sw(*(t(x) for x in args),
                    *(None if x is None else t(x) for x in aero),
                    **{k: t(v) for k, v in kw.items()},
                    ict=scene["ict"], icb=scene["icb"])
        out[aerosol] = (j, p)
    return out


@pytest.mark.parametrize("aerosol", [False, True])
def test_chou_sw(sw_runs, aerosol):
    j, p = sw_runs[aerosol]
    assert set(p) == set(j)
    for k in j:
        assert tuple(p[k].shape) == j[k].shape, k
        assert relmax(p[k].numpy(), j[k]) <= GATE, k


def test_chou_sw_float32_against_float64(scene, sw_runs):
    """Both float32 solves, the port's and the oracle's, within the gate
    of the port's float64 solve of the same inputs: their differences are
    float32 rounding, each side's own (at 8 x 72 the port's is ~1.6e-5,
    the oracle's ~2.8e-5, on the surface diffuse NIR flux)."""
    args, _, kw = _sw_args(scene, False)
    exact = chou_sw(*(t(x).double() for x in args),
                    **{k: t(v).double() for k, v in kw.items()},
                    ict=scene["ict"], icb=scene["icb"])
    j, p = sw_runs[False]
    for k in j:
        ref = exact[k].numpy()
        assert relmax(p[k].numpy(), ref) <= GATE, k
        assert relmax(j[k], ref) <= GATE, k


def test_chou_sw_aerosol_changes_fluxes(sw_runs):
    assert relmax(sw_runs[True][1]["flx"].numpy(),
                  sw_runs[False][1]["flx"].numpy()) > 1e-3


def _lw_args(s):
    a = s["a"]
    emis = np.broadcast_to(a["emis"][:, None], (NCOL, 10)).copy()
    return (a["ple"], a["t"], a["qv"], a["o3"], a["t2m"], a["tsinst"], emis,
            a["co2"], a["n2o"], a["ch4"], a["cfc11"], a["cfc12"],
            a["hcfc22"], s["cwc"], a["fcld"], s["reff"])


@pytest.mark.parametrize("trace", [True, False])
@pytest.mark.parametrize("aerosol", [False, True])
def test_chou_lw(scene, aerosol, trace):
    args = _lw_args(scene)
    aero = _aerosol(10, 12) if aerosol else (None,) * 3
    kw = dict(ict=scene["ict"], icb=scene["icb"], trace=trace,
              with_aerosol=aerosol)
    j = j_chou_lw(*args, *aero, **kw)
    p = chou_lw(*(t(x) for x in args),
                *(None if x is None else t(x) for x in aero), **kw)
    assert set(p) == set(j)
    for k in j:
        assert tuple(p[k].shape) == j[k].shape, k
        assert relmax(p[k].numpy(), j[k]) <= GATE, k
    if aerosol:
        assert relmax(p["flxu"].numpy(), p["flxau"].numpy()) > 1e-4


def test_chou_lw_chunks_are_columns(scene, monkeypatch):
    """Solving the columns in chunks gives each column's result
    unchanged."""
    args = [t(x) for x in _lw_args(scene)]
    kw = dict(ict=scene["ict"], icb=scene["icb"])
    whole = chou_lw(*args, **kw)
    monkeypatch.setattr(chou_lw_module, "CHUNK", 3)
    parts = chou_lw(*args, **kw)
    for k in whole:
        torch.testing.assert_close(parts[k], whole[k], rtol=0, atol=0)


# ------------------------------------------------------------- the driver

@pytest.fixture(scope="module")
def driver_runs(scene):
    """Both packages' Chou refresh + update at doy 172, 12 UTC (night
    columns included), without and with aerosol."""
    ji = scene["ji"]
    ti = example_inputs(NCOL, NLEV, device="cpu")
    out = {}
    for name, kw in (("clear", {}),
                     ("aerosol", dict(sw_aero=_aerosol(8, 21),
                                      lw_aero=_aerosol(10, 22)))):
        jkw = {k: tuple(jnp.asarray(x) for x in v) for k, v in kw.items()}
        tkw = {k: tuple(t(x) for x in v) for k, v in kw.items()}
        js = jstep.radiation_refresh(ji, DOY, UTC, config=CHOU,
                                     ict=scene["ict"], icb=scene["icb"],
                                     **jkw)
        ts = tstep.radiation_refresh(ti, DOY, UTC, config=T_CHOU,
                                     ict=scene["ict"], icb=scene["icb"],
                                     **tkw)
        upd = [mod.radiation_update(*st, inp.tsinst + 0.5, inp.lons,
                                    inp.lats, inp.ple, DOY, UTC + 0.25,
                                    config=c)
               for mod, st, inp, c in ((jstep, js, ji, CHOU),
                                       (tstep, ts, ti, T_CHOU))]
        out[name] = (js, ts, upd)
    return ti, out


@pytest.mark.parametrize("run", ["clear", "aerosol"])
@pytest.mark.parametrize("state", ["solar", "irrad"])
def test_chou_refresh(driver_runs, run, state):
    js, ts, _ = driver_runs[1][run]
    i = 0 if state == "solar" else 1
    cls = SolarState if state == "solar" else IrradState
    for f in cls._fields:
        a, b = getattr(ts[i], f), np.asarray(getattr(js[i], f))
        assert tuple(a.shape) == b.shape, f
        assert relmax(a.numpy(), b) <= GATE, f


@pytest.mark.parametrize("run", ["clear", "aerosol"])
def test_chou_update(driver_runs, run):
    _, _, (ju, tu) = driver_runs[1][run]
    assert set(tu) == set(ju)
    for group in ("sw", "lw"):
        assert set(tu[group]) == set(ju[group])
        for k in ju[group]:
            assert relmax(tu[group][k].numpy(),
                          np.asarray(ju[group][k])) <= GATE, (group, k)
    for k in ("alw", "blw"):
        assert relmax(tu[k].numpy(), np.asarray(ju[k])) <= GATE, k


@pytest.mark.parametrize("run", ["clear", "aerosol"])
def test_chou_heating_rates_reference_form(driver_runs, run):
    """The heating rates divide flux differences by dp (a few Pa near the
    model top), so they are held in the reference's form
    (tests/test_accuracy.py:142-152): |error| x dp in every layer within
    B = 2 (5e-5 max|fsw| + 5e-5 max|flw|) GRAV / CP, and the relative
    rate where dp > 100 Pa within B / 100 Pa over the largest rate
    there."""
    ti, out = driver_runs
    _, _, (ju, tu) = out[run]
    a = tu["dtdt"].double().numpy()
    b = np.asarray(ju["dtdt"], np.float64)
    dp = np.diff(ti.ple.double().numpy(), axis=1)
    div = 2.0 * GATE * (np.abs(np.asarray(ju["sw"]["fsw"])).max()
                        + np.abs(np.asarray(ju["lw"]["flw"])).max()) \
        * GRAV / CP
    err = np.abs(a - b)
    assert (err * dp).max() <= div
    deep = dp > 100.0
    top = np.abs(b[deep]).max()
    assert err[deep].max() / top <= div / (100.0 * top)


def test_chou_state_fills(driver_runs):
    """The Chou fills of the reference: UNDEF cloud fractions, the
    no-aerosol SW internals the all-sky ones without aerosol and UNDEF
    with it (the default outputs skip the no-aerosol pass), zero band
    OLR, DFDTSNA = DFDTS and zero DFDTSCNA; the LW no-aerosol fluxes from
    the same solve."""
    ti, out = driver_runs
    sol = out["clear"][1][0]
    for na, f in (("flxnan", "flxn"), ("flcnan", "flcn"),
                  ("flxunan", "flxun")):
        assert torch.equal(getattr(sol, na), getattr(sol, f)), na
        assert bool((getattr(out["aerosol"][1][0], na) == 1.0e15).all()), na
    for run in ("clear", "aerosol"):
        sol, irr = out[run][1]
        assert bool((sol.cldfrc == 1.0e15).all())
        assert bool((irr.olrb == 0.0).all())
        assert bool((irr.dolrb_dts == 0.0).all())
        assert torch.equal(irr.dfdtsna, irr.dfdts)
        assert bool((irr.dfdtscna == 0.0).all())
    clear, aero = out["clear"][1][1], out["aerosol"][1][1]
    assert torch.equal(clear.flxa, clear.flx)
    assert relmax(aero.flxa.numpy(), aero.flx.numpy()) > 1e-5


def test_lw_aerosol_triple_reaches_chou(scene):
    """radiation_refresh hands Chou LW all three aerosol fields: changing
    the scattering fields alone changes the fluxes."""
    ti = example_inputs(NCOL, NLEV, device="cpu")
    taua, ssaa, asya = (t(x) for x in _aerosol(10, 22))
    kw = dict(config=TConfig(lw_scheme=TScheme.CHOU), ict=scene["ict"],
              icb=scene["icb"])
    a = tstep.radiation_refresh(ti, DOY, UTC, lw_aero=(taua, ssaa, asya),
                                **kw)[1]
    b = tstep.radiation_refresh(ti, DOY, UTC, lw_aero=(taua, 0.5 * ssaa,
                                                       0.5 * asya), **kw)[1]
    direct = trad.irrad_refresh(ti, DOY, kw["config"], scene["ict"],
                                scene["icb"], taua=taua, ssaa=ssaa,
                                asya=asya)
    assert torch.equal(a.flx, direct.flx)
    assert relmax(a.flx.numpy(), b.flx.numpy()) > 1e-5


def test_rrtmg_lw_aerosol_tuple_uses_taua(scene):
    """With RRTMG-LW a (taua, ssaa, asya) triple gives exactly what taua
    alone gives."""
    ti = example_inputs(NCOL, NLEV, device="cpu")
    rng = np.random.default_rng(23)
    taua = t(rng.uniform(0.0, 0.05, (NCOL, NLEV, 16)).astype(np.float32))
    kw = dict(config=TConfig(), ict=scene["ict"], icb=scene["icb"])
    a = tstep.radiation_refresh(ti, DOY, UTC, lw_aero=(taua, taua, taua),
                                **kw)[1]
    b = tstep.radiation_refresh(ti, DOY, UTC, lw_aero=taua, **kw)[1]
    for f in IrradState._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ------------------------------------- physics (tests/test_chou_sw.py)

def _run_sw(prof, cosz=0.7, albedo=0.1):
    ncol = prof["ta"].shape[0]
    alb = torch.full((ncol,), albedo)
    out = chou_sw(torch.full((ncol,), cosz), t(prof["ple"]), t(prof["ta"]),
                  t(prof["wa"]), t(prof["oa"]), t(prof["co2"]),
                  t(prof["cwc"]), t(prof["fcld"]), t(prof["reff"]),
                  rsuvbm=alb, rsuvdf=alb, rsirbm=alb, rsirdf=alb,
                  ict=prof["ict"], icb=prof["icb"])
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def sw_clear():
    prof = make_profile(ncol=4, nlev=72, cloudy=False)
    return prof, _run_sw(prof)


@pytest.fixture(scope="module")
def sw_cloudy():
    prof = make_profile(ncol=4, nlev=72, cloudy=True)
    return prof, _run_sw(prof)


def test_sw_energy_budget_toa(sw_clear):
    out = sw_clear[1]
    total = out["flx"][:, 0] + out["flxu"][:, 0]
    assert np.all(total > 0.95) and np.all(total <= 1.0 + 1e-5), total


def test_sw_net_flux_monotone_decreasing(sw_clear):
    assert np.all(np.diff(sw_clear[1]["flx"], axis=1) < 1e-5)


def test_sw_fractions_in_range(sw_clear):
    for k in ("flx", "flc", "flxu", "flcu"):
        v = sw_clear[1][k]
        assert np.all(v > -1e-6) and np.all(v < 1.0 + 1e-6), k


def test_sw_surface_direct_diffuse_sum(sw_clear):
    out = sw_clear[1]
    down = (out["fdiruv"] + out["fdifuv"] + out["fdirpar"] + out["fdifpar"]
            + out["fdirir"] + out["fdifir"])
    np.testing.assert_allclose(out["flx"][:, -1], 0.9 * down, rtol=0.02)


def test_sw_band_fluxes_sum_to_total(sw_clear):
    out = sw_clear[1]
    np.testing.assert_allclose(out["flx_sfc_band"].sum(axis=1),
                               out["flx"][:, -1], rtol=0.02)


def test_sw_clear_equals_allsky_without_clouds(sw_clear):
    out = sw_clear[1]
    np.testing.assert_allclose(out["flx"], out["flc"], rtol=1e-4, atol=1e-5)


def test_sw_albedo_increases_upward(sw_clear):
    prof = sw_clear[0]
    lo, hi = _run_sw(prof, albedo=0.1), _run_sw(prof, albedo=0.6)
    assert np.all(hi["flxu"][:, 0] > lo["flxu"][:, 0])


def test_sw_clouds_brighten_toa_and_dim_surface(sw_cloudy):
    out = sw_cloudy[1]
    assert np.all(out["flxu"][:, 0] > out["flcu"][:, 0] + 0.005)
    assert np.all(out["flx"][:, -1] < out["flc"][:, -1] - 0.005)


def test_sw_low_sun_more_attenuation(sw_clear):
    prof = sw_clear[0]
    hi_sun, lo_sun = _run_sw(prof, cosz=0.9), _run_sw(prof, cosz=0.2)
    assert np.all(lo_sun["flx"][:, -1] < hi_sun["flx"][:, -1])


def test_sw_atmospheric_absorption_fraction(sw_clear):
    out = sw_clear[1]
    absorbed = out["flx"][:, 0] - out["flx"][:, -1]
    assert np.all(absorbed > 0.08) and np.all(absorbed < 0.40), absorbed


# ------------------------------------- physics (tests/test_chou_lw.py)

def _run_lw(prof):
    ncol = prof["ta"].shape[0]
    out = chou_lw(t(prof["ple"]), t(prof["ta"]), t(prof["wa"]),
                  t(prof["oa"]), t(prof["tb"]), t(prof["ts"]),
                  torch.full((ncol, 10), 0.99), t(prof["co2"]),
                  t(prof["n2o"]), t(prof["ch4"]), t(prof["cfc11"]),
                  t(prof["cfc12"]), t(prof["cfc22"]), t(prof["cwc"]),
                  t(prof["fcld"]), t(prof["reff"]),
                  ict=prof["ict"], icb=prof["icb"])
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def lw_clear():
    prof = make_profile(ncol=4, nlev=72, cloudy=False)
    return prof, _run_lw(prof)


@pytest.fixture(scope="module")
def lw_cloudy():
    prof = make_profile(ncol=4, nlev=72, cloudy=True)
    return prof, _run_lw(prof)


def test_lw_olr_range(lw_clear):
    olr = -lw_clear[1]["flxu"][:, 0]
    assert np.all(olr > 200.0) and np.all(olr < 340.0), olr


def test_lw_surface_downward_range(lw_clear):
    dn = lw_clear[1]["flxd"][:, -1]
    assert np.all(dn > 200.0) and np.all(dn < 450.0), dn


def test_lw_clear_equals_allsky_without_clouds(lw_clear):
    out = lw_clear[1]
    np.testing.assert_allclose(out["flxu"], out["flcu"], rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(out["flxd"], out["flcd"], rtol=1e-5,
                               atol=1e-3)


def test_lw_no_aerosol_variant_matches_when_no_aerosols(lw_clear):
    out = lw_clear[1]
    np.testing.assert_allclose(out["flxu"], out["flxau"], rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(out["flcd"], out["flad"], rtol=1e-6,
                               atol=1e-4)


def test_lw_downward_toa_zero(lw_clear):
    np.testing.assert_allclose(lw_clear[1]["flxd"][:, 0], 0.0, atol=0.3)


def test_lw_sfcem_close_to_emis_sigma_t4(lw_clear):
    prof, out = lw_clear
    expect = -0.99 * 5.6704e-8 * prof["ts"] ** 4
    np.testing.assert_allclose(out["sfcem"], expect, rtol=0.02)


def test_lw_dfdts_negative_at_surface(lw_clear):
    assert np.all(lw_clear[1]["dfdts"][:, -1] < 0.0)


def test_lw_heating_rates_sane(lw_clear):
    prof, out = lw_clear
    net = out["flxu"] + out["flxd"]
    dp = prof["ple"][:, 1:] - prof["ple"][:, :-1]
    hr = (net[:, :-1] - net[:, 1:]) * 9.80665 / (1004.16 * dp) * 86400.0
    pmid = 0.5 * (prof["ple"][:, 1:] + prof["ple"][:, :-1])
    sel = pmid > 100.0
    assert np.all(hr[sel] > -15.0) and np.all(hr[sel] < 12.0)
    assert hr[:, -30:].mean() < 0.0


def test_lw_clouds_reduce_olr(lw_cloudy):
    out = lw_cloudy[1]
    assert np.all(-out["flxu"][:, 0] < -out["flcu"][:, 0] - 1.0)


def test_lw_clouds_increase_surface_downward(lw_cloudy):
    out = lw_cloudy[1]
    assert np.all(out["flxd"][:, -1] >= out["flcd"][:, -1] - 1e-3)


def test_lw_overcast_matches_fractional_limit():
    prof = make_profile(ncol=2, nlev=72, cloudy=True)
    prof["fcld"][prof["fcld"] > 0] = 1.0
    out = _run_lw(prof)
    assert np.all(-out["flxu"][:, 0] < -out["flcu"][:, 0] - 10.0)


def test_lw_more_co2_warms_surface_net(lw_clear):
    prof, out = lw_clear
    prof2 = dict(prof)
    prof2["co2"] = prof["co2"] * 2.0
    out2 = _run_lw(prof2)
    olr1, olr2 = -out["flxu"][:, 0], -out2["flxu"][:, 0]
    assert np.all(olr2 < olr1)
    assert np.all(olr1 - olr2 < 10.0)


# --------------------------------- physics (tests/test_cross_scheme.py)

@pytest.fixture(scope="module")
def clear_inputs():
    inp = example_inputs(NCOL, NLEV, seed=3, device="cpu")
    z = torch.zeros_like(inp.fcld)
    inp = inp._replace(fcld=z, ql=z, qi=z, qr=z, qs=z)
    ple = inp.ple[0].numpy()
    return inp, TConfig().superlayer_indices(0.5 * (ple[1:] + ple[:-1]))


def _irrad(scheme, inp, ict, icb):
    return trad.irrad_refresh(inp, DOY, TConfig(lw_scheme=scheme), ict, icb)


def test_lw_clear_olr_cross_scheme(clear_inputs):
    inp, (ict, icb) = clear_inputs
    olr = {s: -_irrad(s, inp, ict, icb).flc[:, 0].numpy()
           for s in (TScheme.CHOU, TScheme.RRTMG)}
    for s, v in olr.items():
        assert np.all(v > 150.0) and np.all(v < 360.0), (s, v)
    d = np.abs(olr[TScheme.CHOU] - olr[TScheme.RRTMG])
    assert d.max() < 6.0 and d.mean() < 5.0, d


def test_lw_clear_sfc_down_cross_scheme(clear_inputs):
    inp, (ict, icb) = clear_inputs
    chou = _irrad(TScheme.CHOU, inp, ict, icb).flxd[:, -1].numpy()
    rrtmg = _irrad(TScheme.RRTMG, inp, ict, icb).flxd[:, -1].numpy()
    assert np.all(chou > 150.0) and np.all(rrtmg > 150.0)
    assert np.abs(chou - rrtmg).max() < 6.0


def test_sw_clear_net_cross_scheme(clear_inputs):
    inp, (ict, icb) = clear_inputs
    cosz = torch.clamp(torch.cos(inp.lats), 0.0, 1.0)
    day = (cosz > 0.2).numpy()
    assert day.any()
    flc = {s: trad.solar_refresh(inp, cosz, DOY, TConfig(sw_scheme=s), ict,
                                 icb).flcn.numpy()
           for s in (TScheme.CHOU, TScheme.RRTMG)}
    sfc_c, sfc_r = flc[TScheme.CHOU][day, -1], flc[TScheme.RRTMG][day, -1]
    assert np.all(sfc_r > 0.3) and np.all(sfc_r < 1.0)
    assert np.all(np.abs(sfc_c - sfc_r) / sfc_r < 0.045)
