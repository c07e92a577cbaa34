"""The port's RRTMG-SW optics against the JAX CPU oracle on the realistic
scene (8 columns x 72 levels), same inputs on both sides.

Tolerances (relmax = max|a-b| / max|b|, tools/verify_tpu.py:33-36):
McICA with the SW seed order exact (masks and clear counts); cloud optics
<= 1e-6 for iceflag 1, 2 and 3; setcoef integer fields equal, floats
<= 1e-6 except the four fac weights (<= 5e-6: XLA's float32 log is one
ulp off for ~5 % of the pressures, see test_torch_lw_optics.py); taug,
taur and the solar source <= 5e-6 per band against both of the oracle's
engines (the bound test_fast_kernels.py holds those two engines to); the
converted tables equal the oracle's arrays.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.driver import radiation as jrad
from geosradiation_gridcomp_tpu.models.rrtmg import cldprmc_sw as jcld
from geosradiation_gridcomp_tpu.models.rrtmg import lw as jlw
from geosradiation_gridcomp_tpu.models.rrtmg.nrlssi2 import \
    solar_source_weights
from geosradiation_gridcomp_tpu.models.rrtmg.setcoef_sw import \
    setcoef_sw as j_setcoef
from geosradiation_gridcomp_tpu.models.rrtmg.tables_sw import (NGS_SW,
                                                               sw_tables)
from geosradiation_gridcomp_tpu.models.rrtmg.taumol_sw import (
    sfluxzen_only as j_sfluxzen, taumol_sw_fast, taumol_sw_ref)
from geosradiation_gridcomp_tpu.ops import mcica as jm
from geosradiation_gridcomp_tpu.tables import load
from geosradiation_gridcomp_tpu_torch.models.rrtmg.cldprmc_sw import (
    band_optics_coeffs_sw, cldprmc_sw)
from geosradiation_gridcomp_tpu_torch.models.rrtmg.setcoef_sw import \
    setcoef_sw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.sw import (RRTMGSW,
                                                              SEED_ORDER_SW)
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_sw import (
    BAND_KEYS, sfluxzen_only, taumol_sw)
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_sw_cuda import \
    taumol_sw_fast as t_taumol_fast
from geosradiation_gridcomp_tpu_torch.ops import mcica as tm
from geosradiation_gridcomp_tpu_torch.ops.mcica_cuda import (
    mcica_optics_sw, mcica_optics_sw_plain)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from __graft_entry__ import _example_inputs  # noqa: E402

torch.set_num_threads(1)

NCOL, NLEV, DOY = 8, 72, 172.0
MH, LM = 28, 47
INT_FIELDS = ("lower", "jp", "jt", "jt1", "indself", "indfor")


def relmax(a, b, floor=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def sw():
    return RRTMGSW.from_reference_tables()


@pytest.fixture(scope="module")
def scene():
    """The oracle's SW McICA subcolumns and counts, and the inputs of both
    sides."""
    inp = _example_inputs(NCOL, NLEV)
    play, h2o, o3 = jrad._common_derived(inp)
    zm = jlw.mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = jrad._incloud_paths(inp)
    cldy, ciwp_s, clwp_s = jm.generate_stochastic_clouds(
        zm, inp.lats, DOY, play, inp.fcld, ciwp, clwp, 1.0e-20,
        nsubcol=112, inhm=1, seed_order=(3, 2, 1, 0))
    j = dict(inp=inp, play=play, h2o=h2o, o3=o3,
             clouds=(cldy, ciwp_s, clwp_s),
             counts=np.asarray(jm.clear_counts_three_band(cldy, MH, LM)))
    tt = {k: t(v) for k, v in (("play", play), ("zm", zm), ("ciwp", ciwp),
                               ("clwp", clwp), ("fcld", inp.fcld),
                               ("lats", inp.lats), ("ri", inp.ri),
                               ("rl", inp.rl))}
    return j, tt


def _k2_args(tt, sw, iceflag=3):
    alpha, rcorr = tm.overlap_params(tt["zm"], tt["lats"], DOY)
    coeffs = torch.stack(band_optics_coeffs_sw(tt["ri"], tt["rl"],
                                               sw.cloud_tables,
                                               iceflag=iceflag))
    return (tm.subcolumn_keys(tt["play"], SEED_ORDER_SW), alpha, rcorr,
            tt["fcld"], tt["ciwp"], tt["clwp"], tm._sigma_class(tt["fcld"]),
            coeffs, sw.zcw_cols(1))


def test_mcica_sw_seed_order_exact(scene):
    j, tt = scene
    cldy, ciwp_s, clwp_s = tm.generate_stochastic_clouds(
        tt["zm"], tt["lats"], DOY, tt["play"], tt["fcld"], tt["ciwp"],
        tt["clwp"], 1.0e-20, nsubcol=112, inhm=1, seed_order=SEED_ORDER_SW)
    np.testing.assert_array_equal(cldy.numpy(), np.asarray(j["clouds"][0]))
    assert relmax(ciwp_s, j["clouds"][1]) <= 1e-6
    assert relmax(clwp_s, j["clouds"][2]) <= 1e-6
    counts = tm.clear_counts_three_band(cldy, MH, LM)
    np.testing.assert_array_equal(counts.numpy(), j["counts"])
    assert (j["counts"][:, 0] < 112).sum() >= NCOL // 2


@pytest.mark.parametrize("iceflag", [1, 2, 3])
def test_band_optics_coeffs_sw(iceflag, sw):
    rng = np.random.default_rng(iceflag)
    rei = rng.uniform(5.0, 120.0, (4, 30)).astype(np.float32)
    # radii below 2.5 um reach the liquid ssa overshoot clamp
    rel = rng.uniform(1.0, 50.0, (4, 30)).astype(np.float32)
    a = band_optics_coeffs_sw(t(rei), t(rel), sw.cloud_tables,
                              iceflag=iceflag)
    b = jcld.band_optics_coeffs_sw(jnp.asarray(rei), jnp.asarray(rel),
                                   iceflag=iceflag)
    for x, y in zip(a, b):
        assert relmax(x, y) <= 1e-6


@pytest.mark.parametrize("iceflag", [1, 2, 3])
def test_cldprmc_sw(scene, sw, iceflag):
    j, tt = scene
    cldy, ciwp_s, clwp_s = j["clouds"]
    ref = jcld.cldprmc_sw(cldy, ciwp_s, clwp_s, j["inp"].ri, j["inp"].rl,
                          iceflag=iceflag)
    out = cldprmc_sw(t(cldy), t(ciwp_s), t(clwp_s), tt["ri"], tt["rl"],
                     sw.cloud_tables, iceflag=iceflag)
    for a, b in zip(out, ref):
        assert relmax(a, b) <= 1e-6


@pytest.mark.parametrize("iceflag", [1, 3])
def test_k2_plain_matches_oracle_composition(scene, sw, iceflag):
    """generate + clear counts + cldprmc_sw, as sw.py:138-150 composes
    them."""
    j, tt = scene
    tau, ssa, asm, cldy, counts = mcica_optics_sw_plain(
        *_k2_args(tt, sw, iceflag), cloud_mh=MH, cloud_lm=LM, col_block=3)
    ref = jcld.cldprmc_sw(*j["clouds"], j["inp"].ri, j["inp"].rl,
                          iceflag=iceflag)
    swap = lambda x: np.swapaxes(np.asarray(x), -1, -2)
    np.testing.assert_array_equal(cldy.numpy(), swap(j["clouds"][0]))
    np.testing.assert_array_equal(counts.numpy(), j["counts"])
    for a, b in zip((tau, ssa, asm), ref):
        assert relmax(a, swap(b)) <= 1e-6


def test_k2_wrapper_on_cpu_is_plain(scene, sw):
    _, tt = scene
    args = _k2_args(tt, sw)
    a = mcica_optics_sw(*args, cloud_mh=MH, cloud_lm=LM)
    b = mcica_optics_sw_plain(*args, cloud_mh=MH, cloud_lm=LM)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def coefs(scene, sw):
    j, tt = scene
    inp = j["inp"]
    c = jnp.full_like(j["play"], 0.2095)
    args = (j["play"], inp.t, inp.ple * 0.01, j["h2o"], j["o3"], inp.co2,
            inp.ch4, c)
    return j_setcoef(*args), setcoef_sw(*(t(a) for a in args),
                                        sw.reference_tables)


def test_setcoef_sw(coefs):
    jc, tc = coefs
    for f in jc._fields:
        a, b = getattr(tc, f).numpy(), np.asarray(getattr(jc, f))
        if f in INT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            tol = 5e-6 if f.startswith("fac") else 1e-6
            assert relmax(a, b) <= tol, f


@pytest.fixture(scope="module")
def taus(coefs, sw):
    """(port, oracle ref engine, oracle fast engine) taug/taur."""
    jc, tc = coefs
    ref = taumol_sw_ref(jc)
    fast = taumol_sw_fast(jc)
    return (taumol_sw(tc, sw.taumol_tables),
            tuple(np.asarray(x) for x in ref[:2]),
            tuple(np.asarray(x) for x in fast[:2]))


@pytest.mark.parametrize("band", range(16, 30))
def test_taumol_sw_per_band(taus, band):
    sl = slice(NGS_SW[band - 16], NGS_SW[band - 15])
    port, ref, fast = taus
    for oracle in (ref, fast):
        for a, b in zip(port, oracle):
            assert relmax(a[..., sl], b[..., sl]) <= 5e-6


def test_taumol_wrapper_on_cpu_is_plain(coefs, sw, taus):
    a = t_taumol_fast(coefs[1], sw.taumol_tables)
    for x, y in zip(a, taus[0]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("isolvar,kw", [
    (-1, dict(scon=1361.0)), (1, dict(scon=1361.0, solcycfrac=0.3)),
    (2, dict(scon=0.0, indsolvar=(0.16, 900.0)))])
def test_sfluxzen(coefs, sw, isolvar, kw):
    jc, tc = coefs
    svw = solar_source_weights(isolvar, **kw)
    a = sfluxzen_only(tc, sw.solar_sources(svw))
    b = np.asarray(j_sfluxzen(jc, svw))
    assert a.shape == b.shape == (NCOL, 112)
    assert relmax(a, b) <= 5e-6


def test_tables_equal_reference_arrays(sw):
    tabs = sw.taumol_tables
    st = sw_tables()
    n = 0
    for b in range(16, 30):
        for key in BAND_KEYS:
            if key not in st[b]:
                assert (b, key) not in tabs.index
                continue
            want = np.broadcast_to(st[b][key], tabs.get(b, key).shape)
            np.testing.assert_array_equal(tabs.get(b, key).numpy(), want,
                                          err_msg=f"{b} {key}")
            n += 1
    assert n == sum(len(st[b]) - 4 for b in range(16, 30))
    off = tabs.offsets.numpy()
    assert off.dtype == np.int32 and off.shape == (2 * 14 * len(BAND_KEYS),)
    for key in ("preflog", "tref"):
        np.testing.assert_array_equal(getattr(sw, key).numpy(), st[key])
    cld = load("rrtmg_sw_cld")
    for key, v in sw.cloud_tables.items():
        if key != "ice1_coeffs":
            np.testing.assert_array_equal(v.numpy(), cld[key])
    ib5 = np.asarray(cld["icxa"]) - 1
    np.testing.assert_array_equal(sw.ice1_coeffs[1].numpy(),
                                  cld["bbari"][ib5])
