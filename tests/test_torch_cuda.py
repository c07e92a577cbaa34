"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked `gpu`: each test skips where torch sees no CUDA device. This file
imports no jax, so on the card run it past the repo's conftest (which
pins jax to 8 virtual CPU devices):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances (relmax = max|a-b| / max|b|): K1 and K2 masks and counts
exact, cloud optics <= 1e-5; K3 and K5 (per band), K4 and K6 <= 5e-4 (the
reference's kernel-parity gate, tools/verify_tpu.py:115-128); the LW
refresh <= 5e-5 (the LW end-to-end gate); the SW state of the combined
step <= 5e-4 (the SW end-to-end gate, tools/verify_tpu.py:279-281).
"""

import pytest
import torch

from geosradiation_gridcomp_tpu_torch.config import RadiationConfig
from geosradiation_gridcomp_tpu_torch.driver import radiation as rad
from geosradiation_gridcomp_tpu_torch.driver import step
from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
from geosradiation_gridcomp_tpu_torch.models.rrtmg import lw as lwm
from geosradiation_gridcomp_tpu_torch.models.rrtmg import sw as swm
from geosradiation_gridcomp_tpu_torch.models.rrtmg.cldprmc_lw import \
    band_abs_coeffs_lw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.cldprmc_sw import \
    band_optics_coeffs_sw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.rtrnmc import rtrnmc
from geosradiation_gridcomp_tpu_torch.models.rrtmg.rtrnmc_cuda import \
    rtrnmc_fast
from geosradiation_gridcomp_tpu_torch.models.rrtmg.setcoef_lw import \
    setcoef_lw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.setcoef_sw import \
    setcoef_sw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.spcvmc import spcvmc_sw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.spcvmc_cuda import \
    spcvmc_fast
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw import (
    NGS_LW, taumol_lw)
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw_cuda import \
    taumol_lw_fast
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_sw import (
    NGS_SW, taumol_sw)
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_sw_cuda import \
    taumol_sw_fast
from geosradiation_gridcomp_tpu_torch.ops import mcica
from geosradiation_gridcomp_tpu_torch.ops.mcica_cuda import (
    mcica_optics_lw, mcica_optics_lw_plain, mcica_optics_sw,
    mcica_optics_sw_plain)
from geosradiation_gridcomp_tpu_torch.scene import example_inputs

pytestmark = pytest.mark.gpu

NCOL, NLEV, DOY = 96, 72, 172.0


def relmax(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-6))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def case(dev):
    inp = example_inputs(NCOL, NLEV, device=dev)
    lw = lwm.RRTMGLW.from_reference_tables(dev)
    play, h2o, o3 = rad._common_derived(inp)
    zm = lwm.mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = rad._incloud_paths(inp)
    alpha, rcorr = mcica.overlap_params(zm, inp.lats, DOY)
    absi, absl = band_abs_coeffs_lw(inp.ri, inp.rl, lw.cloud_tables)
    k1 = (mcica.subcolumn_keys(play), alpha, rcorr, inp.fcld, ciwp, clwp,
          mcica._sigma_class(inp.fcld), absi.contiguous(), absl.contiguous(),
          lw.zcw_cols(1))
    tlev = lwm.level_temperatures(play, inp.t, inp.ple * 0.01, inp.tsinst)
    emis = inp.emis[:, None].expand(NCOL, 16).contiguous()
    z = torch.zeros_like(inp.co2)
    coefs = setcoef_lw(play, inp.t, inp.ple * 0.01, tlev, inp.tsinst, emis,
                       h2o, o3, inp.co2, inp.ch4, inp.n2o,
                       torch.full_like(z, 0.2095), z, inp.cfc11, inp.cfc12,
                       inp.hcfc22, z, lw.planck_tables)
    sw = swm.RRTMGSW.from_reference_tables(dev)
    coeffs = torch.stack(band_optics_coeffs_sw(inp.ri, inp.rl,
                                               sw.cloud_tables)).contiguous()
    k2 = (mcica.subcolumn_keys(play, swm.SEED_ORDER_SW), *k1[1:7], coeffs)
    swcoefs = setcoef_sw(play, inp.t, inp.ple * 0.01, h2o, o3, inp.co2,
                         inp.ch4, torch.full_like(z, 0.2095),
                         sw.reference_tables)
    return dict(inp=inp, lw=lw, k1=k1, emis=emis, coefs=coefs, sw=sw, k2=k2,
                swcoefs=swcoefs)


@pytest.mark.parametrize("inhm", [0, 1, 2])
def test_k1_matches_plain(case, inhm):
    kw = dict(cloud_mh=30, cloud_lm=50, inhm=inhm)
    args = list(case["k1"])
    args[-1] = case["lw"].zcw_cols(inhm)
    a = mcica_optics_lw(*args, **kw)
    b = mcica_optics_lw_plain(*args, **kw)
    assert torch.equal(a[1], b[1])
    assert torch.equal(a[2], b[2])
    assert relmax(a[0], b[0]) <= 1e-5


@pytest.mark.parametrize("with_taua", [False, True])
def test_k3_matches_plain(case, dev, with_taua):
    taua = (torch.rand(NCOL, NLEV, 16, device=dev) * 0.02 if with_taua
            else None)
    tabs = case["lw"].taumol_tables
    a = taumol_lw_fast(case["coefs"], tabs, taua)
    b = taumol_lw(case["coefs"], tabs, taua)
    for x, y in zip(a, b):
        for i in range(16):
            sl = slice(NGS_LW[i], NGS_LW[i + 1])
            assert relmax(x[..., sl], y[..., sl]) <= 5e-4, i + 1


def test_k4_matches_plain(case):
    c = case["coefs"]
    tau, cloudy, _ = mcica_optics_lw_plain(*case["k1"], cloud_mh=30,
                                           cloud_lm=50)
    tg, pf = taumol_lw(c, case["lw"].taumol_tables)
    args = (case["emis"], tg, pf, cloudy, tau, c.planklay, c.planklev,
            c.plankbnd, c.dplankbnd_dts, c.pwvcm)
    a = rtrnmc_fast(*args)
    b = rtrnmc(*args)
    assert set(a) == set(b)
    for k in b:
        assert relmax(a[k], b[k]) <= 5e-4, k


def test_refresh_runs_the_kernels(case):
    cfg = RadiationConfig()
    inp = case["inp"]
    LAUNCHES.clear()
    st = rad.irrad_refresh(inp, DOY, cfg, 69, 71, lw=case["lw"])
    torch.cuda.synchronize()
    assert all(LAUNCHES[k] == 1
               for k in ("mcica_optics_lw", "taumol_lw", "rtrnmc"))
    ref = rad.irrad_refresh(inp, DOY, cfg, 69, 71, lw=case["lw"], plain=True)
    for f in st._fields:
        assert relmax(getattr(st, f), getattr(ref, f)) <= 5e-5, f


@pytest.mark.parametrize("inhm", [0, 1, 2])
def test_k2_matches_plain(case, inhm):
    kw = dict(cloud_mh=30, cloud_lm=50, inhm=inhm)
    args = (*case["k2"], case["sw"].zcw_cols(inhm))
    a = mcica_optics_sw(*args, **kw)
    b = mcica_optics_sw_plain(*args, **kw)
    assert torch.equal(a[3], b[3])
    assert torch.equal(a[4], b[4])
    for x, y in zip(a[:3], b[:3]):
        assert relmax(x, y) <= 1e-5


def test_k5_matches_plain(case):
    tabs = case["sw"].taumol_tables
    a = taumol_sw_fast(case["swcoefs"], tabs)
    b = taumol_sw(case["swcoefs"], tabs)
    for x, y in zip(a, b):
        for i in range(14):
            sl = slice(NGS_SW[i], NGS_SW[i + 1])
            assert relmax(x[..., sl], y[..., sl]) <= 5e-4, i + 16


@pytest.mark.parametrize("aerosol,ncld", [(False, None), (True, 40)])
def test_k6_matches_plain(case, dev, aerosol, ncld):
    tau, ssa, asm, cldy, _ = mcica_optics_sw_plain(
        *case["k2"], case["sw"].zcw_cols(1), cloud_mh=30, cloud_lm=50)
    tg, tr = taumol_sw(case["swcoefs"], case["sw"].taumol_tables)
    gen = torch.Generator(dev).manual_seed(4)
    rnd = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(
        *shape, device=dev, generator=gen)
    aero = dict(taua=rnd(0.0, 0.1, NCOL, NLEV, 14),
                ssaa=rnd(0.8, 1.0, NCOL, NLEV, 14),
                asya=rnd(0.5, 0.8, NCOL, NLEV, 14)) if aerosol else {}
    args = (case["swcoefs"], tg, tr, rnd(0.1, 20.0, NCOL, 112),
            rnd(-0.2, 1.0, NCOL), rnd(0.05, 0.3, NCOL, 14),
            rnd(0.05, 0.3, NCOL, 14), cldy, tau, ssa, asm)
    a = spcvmc_fast(*args, **aero, ncld=ncld)
    b = spcvmc_sw(*args, **aero, ncld=ncld)
    assert set(a) == set(b)
    for k in b:
        assert relmax(a[k], b[k]) <= 5e-4, k


def test_step_runs_the_kernels(case):
    cfg = RadiationConfig()
    inp, mods = case["inp"], dict(sw=case["sw"], lw=case["lw"])
    bounds = step.sw_partition_bounds(inp.lons, inp.lats, inp.fcld, DOY,
                                      12.0, cfg, bucket=8)
    assert None not in bounds
    kw = dict(config=cfg, ict=69, icb=71, sw_nlit=bounds[0],
              sw_ncld=bounds[1], **mods)
    LAUNCHES.clear()
    sol, irr = step.radiation_refresh(inp, DOY, 12.0, **kw)
    torch.cuda.synchronize()
    assert all(LAUNCHES[k] == 1 for k in (
        "mcica_optics_lw", "taumol_lw", "rtrnmc", "mcica_optics_sw",
        "taumol_sw", "spcvmc"))
    sol_p, irr_p = step.radiation_refresh(inp, DOY, 12.0, plain=True, **kw)
    for f in irr._fields:
        assert relmax(getattr(irr, f), getattr(irr_p, f)) <= 5e-5, f
    for f in sol._fields:
        assert relmax(getattr(sol, f), getattr(sol_p, f)) <= 5e-4, f


def test_wrappers_reject_what_the_kernels_do_not_take(case):
    c = case["coefs"]
    tabs = case["lw"].taumol_tables
    with pytest.raises(ValueError):
        taumol_lw_fast(c, tabs._replace(offsets=tabs.offsets[:-1]))
    args = list(case["k1"])
    args[-1] = args[-1][:2]
    with pytest.raises(ValueError):
        mcica_optics_lw(*args, cloud_mh=30, cloud_lm=50)
    with pytest.raises(ValueError):
        mcica_optics_sw(*case["k2"][:-1], case["k2"][-1][:6],
                        case["sw"].zcw_cols(1), cloud_mh=30, cloud_lm=50)
