"""The port's RRTMG-LW optics and transfer against the JAX CPU oracle, on
the realistic scene (12 columns x 72 levels), same inputs on both sides.

Tolerances (relmax = max|a-b| / max|b|, tools/verify_tpu.py:33-36):
setcoef integer fields equal, floats <= 1e-6 except the four fac weights
(<= 5e-6: they are 5 * (preflog - log(p)) - terms, and XLA's float32 log is
one ulp (4.8e-7 at log(1000 hPa)) off the correctly rounded value for ~5 %
of the scene's pressures, where torch's is not); taumol <= 5e-6 per band, with
and without aerosol (the bound test_fast_kernels.py holds the oracle's own
two engines to); rtrnmc <= 1e-5; cloud optics <= 1e-6; the converted
tables equal the oracle's arrays.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.driver import radiation as jrad
from geosradiation_gridcomp_tpu.models.rrtmg import lw as jlw
from geosradiation_gridcomp_tpu.models.rrtmg.cldprmc_lw import \
    band_abs_coeffs_lw as j_band_abs
from geosradiation_gridcomp_tpu.models.rrtmg.rtrnmc import rtrnmc as j_rtrnmc
from geosradiation_gridcomp_tpu.models.rrtmg.setcoef_lw import \
    setcoef_lw as j_setcoef
from geosradiation_gridcomp_tpu.models.rrtmg.tables_lw import (
    NG_LW, NGS_LW, lw_gather_tables, lw_tables)
from geosradiation_gridcomp_tpu.models.rrtmg.taumol_lw import \
    taumol_lw as j_taumol
from geosradiation_gridcomp_tpu.ops.mcica import _zcw_class_table
from geosradiation_gridcomp_tpu.tables import load
from geosradiation_gridcomp_tpu_torch.models.rrtmg import lw as tlw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.cldprmc_lw import (
    band_abs_coeffs_lw, lw_cloud_tables)
from geosradiation_gridcomp_tpu_torch.models.rrtmg.rtrnmc import rtrnmc
from geosradiation_gridcomp_tpu_torch.models.rrtmg.rtrnmc_cuda import \
    rtrnmc_fast
from geosradiation_gridcomp_tpu_torch.models.rrtmg.setcoef_lw import \
    setcoef_lw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw import (
    BAND_KEYS, taumol_lw)
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw_cuda import \
    taumol_lw_fast

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from __graft_entry__ import _example_inputs  # noqa: E402

torch.set_num_threads(1)

NCOL, NLEV = 12, 72
INT_FIELDS = ("lower", "jp", "jt", "jt1", "indself", "indfor", "indminor")


def relmax(a, b, floor=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def lw():
    return tlw.RRTMGLW.from_reference_tables("cpu")


@pytest.fixture(scope="module")
def setup():
    """Setcoef inputs and outputs on both sides, the oracle's taumol with
    and without aerosol, and a cloud field for rtrnmc."""
    inp = _example_inputs(NCOL, NLEV)
    play, h2o, o3 = jrad._common_derived(inp)
    tlev = jlw.level_temperatures(play, inp.t, inp.ple * 0.01, inp.tsinst)
    emis = jnp.broadcast_to(inp.emis[:, None], (NCOL, 16))
    z = jnp.zeros_like(inp.co2)
    gases = (h2o, o3, inp.co2, inp.ch4, inp.n2o, jnp.full_like(z, 0.2095),
             z + 1.5e-7, inp.cfc11, inp.cfc12, inp.hcfc22, z + 8e-11)
    args = (play, inp.t, inp.ple * 0.01, tlev, inp.tsinst, emis) + gases
    jc = j_setcoef(*args)
    rng = np.random.default_rng(7)
    taua = rng.uniform(0.0, 0.02, (NCOL, NLEV, 16)).astype(np.float32)
    j_tau = {None: j_taumol(jc), "taua": j_taumol(jc, jnp.asarray(taua))}
    return dict(args=args, jc=jc, taua=taua,
                j_tau={k: tuple(np.asarray(x) for x in v)
                       for k, v in j_tau.items()})


@pytest.fixture(scope="module")
def coefs(setup, lw):
    return setcoef_lw(*(t(a) for a in setup["args"]), lw.planck_tables)


@pytest.fixture(scope="module")
def port_tau(setup, coefs, lw):
    return {None: taumol_lw(coefs, lw.taumol_tables),
            "taua": taumol_lw(coefs, lw.taumol_tables, t(setup["taua"]))}


def test_level_temperatures_and_mid_heights():
    inp = _example_inputs(NCOL, NLEV)
    play = jrad._common_derived(inp)[0]
    jt = jlw.level_temperatures(play, inp.t, inp.ple * 0.01, inp.tsinst)
    tt = tlw.level_temperatures(t(play), t(inp.t), t(inp.ple) * 0.01,
                                t(inp.tsinst))
    assert relmax(tt, jt) <= 1e-6
    jz = jlw.mid_heights(play, inp.t, inp.ple[..., -1])
    tz = tlw.mid_heights(t(play), t(inp.t), t(inp.ple)[..., -1])
    assert relmax(tz, jz) <= 1e-6


def test_setcoef_lw(setup, coefs):
    jc = setup["jc"]
    for f in jc._fields:
        a, b = getattr(coefs, f).numpy(), np.asarray(getattr(jc, f))
        if f in INT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            tol = 5e-6 if f.startswith("fac") else 1e-6
            assert relmax(a, b) <= tol, f


@pytest.mark.parametrize("aerosol", [None, "taua"])
@pytest.mark.parametrize("band", range(1, 17))
def test_taumol_lw_per_band(setup, port_tau, band, aerosol):
    sl = slice(NGS_LW[band - 1], NGS_LW[band])
    tg, pf = port_tau[aerosol]
    jtg, jpf = setup["j_tau"][aerosol]
    assert relmax(tg[..., sl], jtg[..., sl]) <= 5e-6
    assert relmax(pf[..., sl], jpf[..., sl]) <= 5e-6


def test_taumol_wrapper_on_cpu_is_plain(setup, coefs, lw, port_tau):
    for key, taua in ((None, None), ("taua", t(setup["taua"]))):
        a = taumol_lw_fast(coefs, lw.taumol_tables, taua)
        for x, y in zip(a, port_tau[key]):
            assert torch.equal(x, y)


@pytest.fixture(scope="module")
def rt_inputs(setup, coefs, port_tau):
    """rtrnmc inputs: the oracle's gas optics and a random cloud field."""
    rng = np.random.default_rng(11)
    jtg, jpf = setup["j_tau"][None]
    cloudy = rng.uniform(size=(NCOL, NLEV)) < 0.2
    taucmc = np.where(cloudy[..., None],
                      rng.exponential(2.0, (NCOL, NLEV, 140)), 0.0
                      ).astype(np.float32)
    jc = setup["jc"]
    emis = np.asarray(setup["args"][5])
    return (emis, jtg, jpf, cloudy, taucmc, np.asarray(jc.planklay),
            np.asarray(jc.planklev), np.asarray(jc.plankbnd),
            np.asarray(jc.dplankbnd_dts), np.asarray(jc.pwvcm))


def test_rtrnmc(rt_inputs):
    jo = j_rtrnmc(*(jnp.asarray(a) for a in rt_inputs), dudts=True)
    to = rtrnmc(*(t(a) for a in rt_inputs), dudts=True)
    assert set(to) == set(jo)
    for k in jo:
        assert relmax(to[k], jo[k]) <= 1e-5, k


def test_rtrnmc_wrapper_on_cpu_is_plain(rt_inputs):
    args = [t(a) for a in rt_inputs]
    a = rtrnmc_fast(*args, dudts=False)
    b = rtrnmc(*args, dudts=False)
    assert set(a) == set(b) == {"uflx", "dflx", "uflxc", "dflxc", "olrb"}
    for k in a:
        assert torch.equal(a[k], b[k])


@pytest.mark.parametrize("iceflag", [0, 1, 2, 3, 4])
def test_band_abs_coeffs(iceflag):
    rng = np.random.default_rng(iceflag)
    rei = rng.uniform(5.0, 120.0, (4, 30)).astype(np.float32)
    rel = rng.uniform(2.5, 50.0, (4, 30)).astype(np.float32)
    ja, jl = j_band_abs(jnp.asarray(rei), jnp.asarray(rel), iceflag=iceflag)
    ta, tl = band_abs_coeffs_lw(t(rei), t(rel), lw_cloud_tables("cpu"),
                                iceflag=iceflag)
    assert relmax(ta, ja) <= 1e-6
    assert relmax(tl, jl) <= 1e-6


def test_tables_equal_reference_arrays(lw):
    tabs = lw.taumol_tables
    lt = lw_tables()
    gt = lw_gather_tables()
    np.testing.assert_array_equal(tabs.get(0, "chi_mls").numpy(),
                                  lt["chi_mls"])
    np.testing.assert_array_equal(tabs.get(0, "self10").numpy(), gt["self10"])
    np.testing.assert_array_equal(tabs.get(0, "for4").numpy(), gt["for4"])
    n = 0
    for b in range(1, 17):
        assert len(lt[b]) - 2 == sum((b, k) in tabs.index for k in BAND_KEYS)
        for k in BAND_KEYS:
            if k in lt[b]:
                np.testing.assert_array_equal(tabs.get(b, k).numpy(),
                                              lt[b][k], err_msg=f"{b} {k}")
                n += 1
        g = slice(NGS_LW[b - 1], NGS_LW[b])
        np.testing.assert_array_equal(gt["self10"][:, g], lt[b]["selfref"])
        np.testing.assert_array_equal(gt["for4"][:, g], lt[b]["forref"])
    assert n == sum(len(lt[b]) - 2 for b in range(1, 17))
    off = tabs.offsets.numpy()
    assert off.dtype == np.int32 and off.shape == (16 * len(BAND_KEYS) + 3,)
    for key in ("preflog", "tref", "totplnk", "totplnkderiv"):
        np.testing.assert_array_equal(getattr(lw, key).numpy(), lt[key])
    cld = load("rrtmg_lw_cld")
    for key, v in lw.cloud_tables.items():
        np.testing.assert_array_equal(v.numpy(), cld[key])
    for inhm, buf in ((1, lw.zcw_beta), (2, lw.zcw_gamma)):
        t2 = np.asarray(_zcw_class_table(inhm)).reshape(96, 32, 2)
        np.testing.assert_array_equal(
            buf.numpy(), t2[..., 0].reshape(3, 1024)[:, :1000])
    assert sum(NG_LW) == 140
