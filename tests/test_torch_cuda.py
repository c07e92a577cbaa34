"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked `gpu`: each test skips where torch sees no CUDA device. This file
imports no jax, so on the card run it past the repo's conftest (which
pins jax to 8 virtual CPU devices):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances (relmax = max|a-b| / max|b|): K1 and K2 masks and counts
exact, cloud optics <= 1e-5 (K2 for every iceflag and condensate PDF;
K1 for the seed orders of tools/verify.py too, its subkeys derived in the
kernel); K3 and K5 (per band, also on ragged tiles),
K4 (also at other shapes, and equal to itself over two runs) and K6 <=
5e-4 (the
reference's kernel-parity gate, tools/verify_tpu.py:115-128); the LW
refresh <= 5e-5 (the LW end-to-end gate); the SW state of the combined
step <= 5e-4 (the SW end-to-end gate, tools/verify_tpu.py:279-281). K7,
P1 and both P2 kernels exact, gather_rows in every case of its contract
(gather_cuda.ROWS_CASES); P3's full variant equal to K3 bit for bit,
every variant <= 5e-4 per band (K3's gate). K1, K2, K4, K5 and K6's
wrappers run under torch.cuda.set_sync_debug_mode("error"): none
synchronises the stream. RATS with the kernels (K1, K3 and K4 launched
once per gas) against the twins, every gas <= 5e-5, and K3 <= 5e-4 per
band on each gas's inputs; the Chou-Suarez
refresh + update on the card against the same functions on the CPU
<= 5e-5 (no kernel launched); a checkpoint loaded onto the card, and a
run restarted from it bitwise equal to the uninterrupted run. RRTMGP: the
facade refresh launches K3, K4 and K5 once each and nothing else, its
states against plain=True at the step's gates; the native engine on the
card launches no kernel and is within 5e-5 of the CPU. The column
sharding: the refresh over column_mesh() and over two shards on the one
card bitwise equal to the unsharded one, K1-K6 launched; StagedFeed's
round trip through pinned memory and a side stream. The satellite
simulators: cosp_simulator on the card against the CPU (integers exact,
fill values in place, counts exact, floats <= 5e-5, no kernel), and the
radar's point blocks bitwise equal to one unblocked call.
"""

import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu_torch.config import RadiationConfig, Scheme
from geosradiation_gridcomp_tpu_torch.driver import radiation as rad
from geosradiation_gridcomp_tpu_torch.driver import step
from geosradiation_gridcomp_tpu_torch.driver.checkpoint import (
    load_checkpoint, save_checkpoint)
from geosradiation_gridcomp_tpu_torch.driver.clock import RadiationClock
from geosradiation_gridcomp_tpu_torch.driver.diagnostics import (
    RATS_GASES, rats_refresh, rats_update)
from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
from geosradiation_gridcomp_tpu_torch.models.rrtmg import lw as lwm
from geosradiation_gridcomp_tpu_torch.models.rrtmg import sw as swm
from geosradiation_gridcomp_tpu_torch.models.rrtmg.cldprmc_lw import \
    band_abs_coeffs_lw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.cldprmc_sw import \
    CloudPackSW
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
    NGS_LW, PARTS, VARIANTS, _cells, taumol_lw)
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw_cuda import (
    taumol_lw_bisect, taumol_lw_fast)
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_sw import (
    NGS_SW, taumol_sw)
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_sw_cuda import \
    taumol_sw_fast
from geosradiation_gridcomp_tpu_torch.ops import mcica, threefry
from geosradiation_gridcomp_tpu_torch.ops.ffill_cuda import ffill, ffill_plain
from geosradiation_gridcomp_tpu_torch.ops.gather_cuda import (
    ROWS_CASES, gather_lanes, gather_lanes_plain, gather_rows,
    gather_rows_plain, rows_vec)
from geosradiation_gridcomp_tpu_torch.ops.mcica_cuda import (
    mcica_optics_lw, mcica_optics_lw_plain, mcica_optics_sw,
    mcica_optics_sw_plain, mcica_subcols_raw, mcica_subcols_raw_plain)
from geosradiation_gridcomp_tpu_torch.parallel.distributed import (
    StagedFeed, run_steps_overlapped)
from geosradiation_gridcomp_tpu_torch.parallel.sharding import (
    column_mesh, run_sharded, shard_columns)
from geosradiation_gridcomp_tpu_torch.satsim import (SatsimInputs,
                                                     cosp_simulator, radar)
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
    k1 = (play, alpha, rcorr, inp.fcld, ciwp, clwp,
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
    # liquid radii below 2.5 um in cloudy cells: the ssa overshoot clamp
    rel = inp.rl.clone()
    rel[:8, 40:44] = torch.tensor([1.1, 1.35, 1.6, 2.3], device=dev)
    k2 = (*k1[:7], inp.ri, rel, sw.cloud_pack(3))
    swcoefs = setcoef_sw(play, inp.t, inp.ple * 0.01, h2o, o3, inp.co2,
                         inp.ch4, torch.full_like(z, 0.2095),
                         sw.reference_tables)
    return dict(inp=inp, lw=lw, k1=k1, keys=mcica.subcolumn_keys(play),
                emis=emis, coefs=coefs, sw=sw, k2=k2, swcoefs=swcoefs)


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


@pytest.mark.parametrize("seed_order", [(3, 2, 1, 0), (1, 2, 3, 0),
                                        (2, 3, 0, 1), (3, 0, 1, 2)], ids=str)
def test_k1_seed_orders(case, seed_order):
    """K1's in-kernel subkeys in the other orders: the twin's realization
    (ops.mcica.subcolumn_keys) exactly."""
    kw = dict(cloud_mh=30, cloud_lm=50, seed_order=seed_order)
    a = mcica_optics_lw(*case["k1"], **kw)
    b = mcica_optics_lw_plain(*case["k1"], **kw)
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


def _cell_block(coefs, start, shape):
    """The fields of coefs at the flat cells start.. as an array of cells
    of the given shape (columns x layers, or a flat cell axis)."""
    n = 1
    for d in shape:
        n *= d
    flat = _cells(coefs, coefs.jp.shape, slice(start, start + n))
    return type(flat)(*(x.reshape(shape + x.shape[1:])
                        if x.shape[:1] == (n,) else x for x in flat))


@pytest.mark.parametrize("shape", [(1,), (31,), (33,), (203,), (6881,),
                                   (37, 72), (65, 3)], ids=str)
@pytest.mark.parametrize("with_taua", [False, True])
def test_k3_ragged_tiles(case, dev, shape, with_taua):
    """Cell arrays whose last tile of 32 columns is part full; P3's full
    variant equal to K3 on them."""
    coefs = _cell_block(case["coefs"], 9, shape)
    taua = (torch.rand(shape + (16,), device=dev) * 0.02 if with_taua
            else None)
    tabs = case["lw"].taumol_tables
    a = taumol_lw_fast(coefs, tabs, taua)
    b = taumol_lw(coefs, tabs, taua)
    for x, y in zip(a, b):
        assert x.shape == shape + (140,)
        for i in range(16):
            sl = slice(NGS_LW[i], NGS_LW[i + 1])
            assert relmax(x[..., sl], y[..., sl]) <= 5e-4, i + 1
    if not with_taua:
        for x, y in zip(taumol_lw_bisect(coefs, tabs, PARTS), a):
            assert torch.equal(x, y)


def test_k4_matches_plain(case):
    args = _k4_case_args(case)
    a = rtrnmc_fast(*args)
    b = rtrnmc(*args)
    assert set(a) == set(b)
    for k in b:
        assert relmax(a[k], b[k]) <= 5e-4, k


def _k4_random(dev, ncol, nlay, seed):
    """rtrnmc's inputs drawn at random at any shape: thin and thick gas
    layers, cloud in ~30 % of the layers on ~70 % of their g-points."""
    gen = torch.Generator(dev).manual_seed(seed)
    r = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(
        *shape, device=dev, generator=gen)
    cloudy = r(0.0, 1.0, ncol, nlay) > 0.7
    taucmc = torch.where(cloudy[..., None]
                         & (r(0.0, 1.0, ncol, nlay, 140) > 0.3),
                         r(0.0, 5.0, ncol, nlay, 140), 0.0)
    return (r(0.9, 1.0, ncol, 16), r(0.0, 1.5, ncol, nlay, 140) ** 2,
            r(0.0, 0.2, ncol, nlay, 140), cloudy, taucmc,
            r(0.01, 0.1, ncol, nlay, 16), r(0.01, 0.1, ncol, nlay + 1, 16),
            r(0.01, 0.1, ncol, 16), r(1e-4, 1e-3, ncol, 16),
            r(0.1, 6.0, ncol))


@pytest.mark.parametrize("ncol,nlay", [(1, 72), (33, 72), (96, 5),
                                       (7, 137)], ids=str)
def test_k4_shapes(dev, ncol, nlay):
    """K4 on one column, on a few layers (fewer than its ring holds) and
    on 137 (its shared memory beyond 48 KB)."""
    args = _k4_random(dev, ncol, nlay, ncol + nlay)
    a = rtrnmc_fast(*args)
    b = rtrnmc(*args)
    for k in b:
        assert a[k].shape == b[k].shape
        assert relmax(a[k], b[k]) <= 5e-4, k


def _k4_case_args(case):
    c = case["coefs"]
    tau, cloudy, _ = mcica_optics_lw_plain(*case["k1"], cloud_mh=30,
                                           cloud_lm=50)
    tg, pf = taumol_lw(c, case["lw"].taumol_tables)
    return (case["emis"], tg, pf, cloudy, tau, c.planklay, c.planklev,
            c.plankbnd, c.dplankbnd_dts, c.pwvcm)


def test_k4_run_to_run(case):
    args = _k4_case_args(case)
    a, again = rtrnmc_fast(*args), rtrnmc_fast(*args)
    for k in a:
        assert torch.equal(a[k], again[k]), k


def _k2_kw(inhm=1):
    return dict(cloud_mh=30, cloud_lm=50, inhm=inhm,
                seed_order=swm.SEED_ORDER_SW)


def test_wrappers_do_not_synchronise(case, dev):
    """K1, K2, K4, K5 and K6's wrappers copy nothing from the host per
    call: under set_sync_debug_mode("error") a synchronising call
    raises."""
    k4 = _k4_case_args(case)
    tg, tr = taumol_sw(case["swcoefs"], case["sw"].taumol_tables)
    k2 = (*case["k2"], case["sw"].zcw_cols(1))
    tau, ssa, asm, cldy, _ = mcica_optics_sw_plain(*k2, **_k2_kw())
    gen = torch.Generator(dev).manual_seed(8)
    rnd = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(
        *shape, device=dev, generator=gen)
    k6 = (case["swcoefs"], tg, tr, rnd(0.1, 20.0, NCOL, 112),
          rnd(-0.2, 1.0, NCOL), rnd(0.05, 0.3, NCOL, 14),
          rnd(0.05, 0.3, NCOL, 14), cldy, tau, ssa, asm)
    calls = ((mcica_optics_lw, case["k1"], dict(cloud_mh=30, cloud_lm=50)),
             (mcica_optics_sw, k2, _k2_kw()),
             (rtrnmc_fast, k4, {}),
             (taumol_sw_fast, (case["swcoefs"], case["sw"].taumol_tables),
              {}),
             (spcvmc_fast, k6, dict(ncld=40)))
    for fn, args, kw in calls:
        fn(*args, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn, args, kw in calls:
            fn(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


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
    _k2_matches_plain(case, case["k2"], inhm)


@pytest.mark.parametrize("iceflag", [1, 2])
@pytest.mark.parametrize("inhm", [0, 2])
def test_k2_other_iceflags(case, iceflag, inhm):
    _k2_matches_plain(case, (*case["k2"][:-1],
                             case["sw"].cloud_pack(iceflag)), inhm)


@pytest.mark.parametrize("ncol", [1, 33])
def test_k2_odd_columns(case, ncol):
    """A last block of two columns half empty."""
    k2 = (*(x[:ncol].contiguous() for x in case["k2"][:-1]), case["k2"][-1])
    _k2_matches_plain(case, k2, 1)


def _k2_matches_plain(case, k2, inhm):
    args = (*k2, case["sw"].zcw_cols(inhm))
    a = mcica_optics_sw(*args, **_k2_kw(inhm))
    b = mcica_optics_sw_plain(*args, **_k2_kw(inhm))
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


@pytest.mark.parametrize("shape", [(1,), (31,), (33,), (203,), (6881,),
                                   (37, 72), (65, 3)], ids=str)
def test_k5_ragged_tiles(case, shape):
    """Cell arrays whose last tile of 32 columns is part full."""
    coefs = _cell_block(case["swcoefs"], 9, shape)
    tabs = case["sw"].taumol_tables
    a = taumol_sw_fast(coefs, tabs)
    b = taumol_sw(coefs, tabs)
    for x, y in zip(a, b):
        assert x.shape == shape + (112,)
        for i in range(14):
            sl = slice(NGS_SW[i], NGS_SW[i + 1])
            assert relmax(x[..., sl], y[..., sl]) <= 5e-4, i + 16


@pytest.mark.parametrize("aerosol,ncld", [(False, None), (True, 40)])
def test_k6_matches_plain(case, dev, aerosol, ncld):
    tau, ssa, asm, cldy, _ = mcica_optics_sw_plain(
        *case["k2"], case["sw"].zcw_cols(1), **_k2_kw())
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


@pytest.mark.parametrize("ncld", [0, 2, NCOL])
@pytest.mark.parametrize("aerosol", [False, True])
def test_k6_ncld(case, dev, aerosol, ncld):
    """K6 with no, some and every column cloudy: within 5e-4 of its twin,
    deterministic over two runs."""
    tau, ssa, asm, cldy, _ = mcica_optics_sw_plain(
        *case["k2"], case["sw"].zcw_cols(1), **_k2_kw())
    tg, tr = taumol_sw(case["swcoefs"], case["sw"].taumol_tables)
    gen = torch.Generator(dev).manual_seed(7)
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
    for k in b:
        assert relmax(a[k], b[k]) <= 5e-4, k
    again = spcvmc_fast(*args, **aero, ncld=ncld)
    for k in a:
        assert torch.equal(again[k], a[k]), k


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


def test_rrtmgp_refresh_runs_k3_k4_k5(case):
    """The RRTMGP facade: K3, K4 and K5 once each per refresh, no other
    kernel; the states against plain=True at the step's gates."""
    cfg = RadiationConfig(sw_scheme=Scheme.RRTMGP, lw_scheme=Scheme.RRTMGP)
    kw = dict(config=cfg, ict=69, icb=71, sw=case["sw"], lw=case["lw"])
    LAUNCHES.clear()
    sol, irr = step.radiation_refresh(case["inp"], DOY, 12.0, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"taumol_lw": 1, "rtrnmc": 1, "taumol_sw": 1}
    sol_p, irr_p = step.radiation_refresh(case["inp"], DOY, 12.0,
                                          plain=True, **kw)
    for f in irr._fields:
        assert relmax(getattr(irr, f), getattr(irr_p, f)) <= 5e-5, f
    for f in sol._fields:
        assert relmax(getattr(sol, f), getattr(sol_p, f)) <= 5e-4, f


def test_rrtmgp_native_on_the_card_matches_the_cpu(dev, tmp_path):
    """RRTMGP through the native engine (chip_smoke's synthetic 2-band
    set) on the card: no kernel launched, within 5e-5 of the CPU."""
    from chip_smoke import save_kdist_npz, synthetic_kdist
    paths = [str(tmp_path / f"{b}.npz") for b in ("lw", "sw")]
    for p in paths:
        save_kdist_npz(synthetic_kdist(), p)
    cfg = RadiationConfig(sw_scheme=Scheme.RRTMGP, lw_scheme=Scheme.RRTMGP,
                          rrtmgp_kdist_lw=paths[0], rrtmgp_kdist_sw=paths[1],
                          outputs=frozenset({"olrb"}))
    outs = []
    for device in (dev, "cpu"):
        inp = example_inputs(64, NLEV, device=device)
        LAUNCHES.clear()
        sol, irr = step.radiation_refresh(inp, DOY, 12.0, config=cfg,
                                          ict=69, icb=71)
        upd = step.radiation_update(sol, irr, inp.tsinst + 0.5, inp.lons,
                                    inp.lats, inp.ple, DOY, 12.25,
                                    config=cfg)
        assert not LAUNCHES
        outs.append((sol, irr, upd))
    (sol, irr, upd), (sol_c, irr_c, upd_c) = outs
    assert tuple(irr.olrb.shape) == (64, 2)
    for a, b in ((sol, sol_c), (irr, irr_c)):
        for f in a._fields:
            assert relmax(getattr(a, f).cpu(), getattr(b, f)) <= 5e-5, f
    for group in ("sw", "lw"):
        for k in upd_c[group]:
            assert relmax(upd[group][k].cpu(), upd_c[group][k]) <= 5e-5, k


def test_wrappers_reject_what_the_kernels_do_not_take(case):
    c = case["coefs"]
    tabs = case["lw"].taumol_tables
    with pytest.raises(ValueError):
        taumol_lw_fast(c, tabs._replace(offsets=tabs.offsets[:-1]))
    args = list(case["k1"])
    args[-1] = args[-1][:2]
    with pytest.raises(ValueError):
        mcica_optics_lw(*args, cloud_mh=30, cloud_lm=50)
    pack = case["k2"][-1]
    for bad in (pack._replace(pack=pack.pack[:-14]), pack._replace(iceflag=4),
                CloudPackSW(pack.pack, 2, pack.nice, pack.nliq)):
        with pytest.raises(ValueError):
            mcica_optics_sw(*case["k2"][:-1], bad, case["sw"].zcw_cols(1),
                            **_k2_kw())
    with pytest.raises(ValueError):
        mcica_optics_sw(*case["k2"], case["sw"].zcw_cols(1),
                        **{**_k2_kw(), "seed_order": (0, 1, 2, 4)})
    # K5 reads the fields in place: an index of another type or a field
    # that is not contiguous is refused, not copied
    sc, stabs = case["swcoefs"], case["sw"].taumol_tables
    with pytest.raises(TypeError):
        taumol_sw_fast(sc._replace(jp=sc.jp.long()), stabs)
    with pytest.raises(ValueError):
        taumol_sw_fast(sc._replace(fac00=sc.fac00.t().contiguous().t()),
                       stabs)
    k4 = list(_k4_case_args(case))
    k4[3] = k4[3].float()
    with pytest.raises(TypeError):
        rtrnmc_fast(*k4)


def test_k7_equals_plain(case):
    args = (case["keys"], *case["k1"][1:4])
    a = mcica_subcols_raw(*args, nsub=140)
    b = mcica_subcols_raw_plain(*args, nsub=140)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_p1_equals_plain(dev):
    gen = torch.Generator(dev).manual_seed(5)
    v = torch.rand(16, 72, 140, device=dev, generator=gen)
    keep = (torch.rand(16, 72, 140, device=dev, generator=gen) > 0.6).float()
    assert torch.equal(ffill(v, keep), ffill_plain(v, keep))


def test_p2_equals_plain(dev):
    gen = torch.Generator(dev).manual_seed(6)
    tab = torch.randn(585, 16, device=dev, generator=gen)
    idx = torch.randint(0, 585, (8192,), device=dev, generator=gen,
                        dtype=torch.int32)
    assert torch.equal(gather_rows(idx, tab), gather_rows_plain(idx, tab))
    tabt = torch.nn.functional.pad(tab.T, (0, 640 - 585)).contiguous()
    idx2d = idx.reshape(64, 128)
    assert torch.equal(gather_lanes(idx2d, tabt),
                       gather_lanes_plain(idx2d, tabt))


@pytest.mark.parametrize("name", sorted(ROWS_CASES))
def test_p2_rows_contract_equals_plain(dev, name):
    """gather_rows in each case of its contract, through its template
    instance: float4, float2 (ng 14) or float (ng 5, a table off 16 B)."""
    n, rows, ng, lo, hi, off = ROWS_CASES[name]
    gen = torch.Generator(dev).manual_seed(6)
    tab = torch.randn(rows * ng + off, device=dev, generator=gen)[off:] \
        .view(rows, ng)
    idx = torch.randint(lo, hi, (n,), device=dev, generator=gen,
                        dtype=torch.int32)
    out = gather_rows(idx, tab)
    assert torch.equal(out, gather_rows_plain(idx, tab))
    assert rows_vec(tab, out) == {"ng14": 2, "ng5": 1,
                                  "unaligned": 1}.get(name, 4)


def test_p3_full_equals_k3(case):
    tabs = case["lw"].taumol_tables
    for x, y in zip(taumol_lw_bisect(case["coefs"], tabs, PARTS),
                    taumol_lw_fast(case["coefs"], tabs)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_p3_matches_plain(case, variant):
    parts = VARIANTS[variant]
    tabs = case["lw"].taumol_tables
    a = taumol_lw_bisect(case["coefs"], tabs, parts)
    b = taumol_lw(case["coefs"], tabs, parts=parts)
    for x, y in zip(a, b):
        for i in range(16):
            sl = slice(NGS_LW[i], NGS_LW[i + 1])
            assert relmax(x[..., sl], y[..., sl]) <= 5e-4, i + 1


@pytest.fixture(scope="module")
def rats(dev):
    """RATS at 64 x 72 with the kernels (K3's inputs of each solve kept)
    and with the twins."""
    inp = example_inputs(64, NLEV, device=dev)
    lw = lwm.RRTMGLW.from_reference_tables(dev)
    cfg = RadiationConfig()
    k3_calls = []

    def k3_recorded(*args, **kwargs):
        k3_calls.append((args, kwargs))
        return taumol_lw_fast(*args, **kwargs)
    lwm.taumol_lw_fast = k3_recorded
    try:
        torch.cuda.synchronize()
        LAUNCHES.clear()
        kern = rats_refresh(inp, DOY, cfg, 69, 71, lw=lw)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    finally:
        lwm.taumol_lw_fast = taumol_lw_fast
    plain = rats_refresh(inp, DOY, cfg, 69, 71, lw=lw, plain=True)
    return inp, lw, kern, plain, launches, k3_calls


def test_rats_launches_each_lw_kernel_once_per_gas(rats):
    launches = rats[4]
    for k in ("mcica_optics_lw", "taumol_lw", "rtrnmc"):
        assert launches.get(k) == len(RATS_GASES), (k, launches)


@pytest.mark.parametrize("gas", RATS_GASES)
def test_k3_with_gas_zeroed(rats, gas):
    """K3 against its twin on the inputs each RATS solve gave it."""
    args, kwargs = rats[5][RATS_GASES.index(gas)]
    for x, y in zip(taumol_lw_fast(*args, **kwargs),
                    taumol_lw(*args, **kwargs)):
        for i in range(16):
            sl = slice(NGS_LW[i], NGS_LW[i + 1])
            assert relmax(x[..., sl], y[..., sl]) <= 5e-4, i + 1


@pytest.mark.parametrize("gas", RATS_GASES)
def test_rats_matches_plain(rats, gas):
    _, _, kern, plain, _, _ = rats
    g = RATS_GASES.index(gas)
    for f in kern._fields:
        assert relmax(getattr(kern, f)[g], getattr(plain, f)[g]) <= 5e-5, f


def test_rats_forcing_on_the_card(rats):
    inp, lw, kern, _, _, _ = rats
    irr = rad.irrad_refresh(inp, DOY, RadiationConfig(), 69, 71, lw=lw)
    _, forcing = rats_update(kern, irr, inp.tsinst + 0.5)
    toa = forcing[:, :, 0]
    co2, ch4 = toa[RATS_GASES.index("CO2")], toa[RATS_GASES.index("CH4")]
    assert float(co2.mean()) > float(ch4.mean()) > 0.0


def test_chou_on_the_card_matches_the_cpu(dev):
    cfg = RadiationConfig(sw_scheme=Scheme.CHOU, lw_scheme=Scheme.CHOU)
    outs = []
    for device in (dev, "cpu"):
        inp = example_inputs(64, NLEV, device=device)
        LAUNCHES.clear()
        sol, irr = step.radiation_refresh(inp, DOY, 12.0, config=cfg,
                                          ict=69, icb=71)
        upd = step.radiation_update(sol, irr, inp.tsinst + 0.5, inp.lons,
                                    inp.lats, inp.ple, DOY, 12.25,
                                    config=cfg)
        assert not LAUNCHES
        outs.append((sol, irr, upd))
    (sol, irr, upd), (sol_c, irr_c, upd_c) = outs
    for a, b in ((sol, sol_c), (irr, irr_c)):
        for f in a._fields:
            assert relmax(getattr(a, f).cpu(), getattr(b, f)) <= 5e-5, f
    for group in ("sw", "lw"):
        for k in upd_c[group]:
            assert relmax(upd[group][k].cpu(), upd_c[group][k]) <= 5e-5, k


def test_checkpoint_onto_the_card_restarts_bitwise(dev, tmp_path):
    inp = example_inputs(64, NLEV, device=dev)
    cfg = RadiationConfig()
    mods = dict(sw=swm.RRTMGSW.from_reference_tables(dev),
                lw=lwm.RRTMGLW.from_reference_tables(dev))

    def run(clk, n, sol, irr):
        outs = []
        for _ in range(n):
            for act in clk.tick():
                if act == "refresh":
                    sol, irr = step.radiation_refresh(
                        inp, clk.doy, clk.utc_hours, config=cfg, ict=69,
                        icb=71, **mods)
                else:
                    outs.append(step.radiation_update(
                        sol, irr, inp.tsinst, inp.lons, inp.lats, inp.ple,
                        clk.doy, clk.utc_hours, config=cfg))
        return sol, irr, outs

    def start():
        clk = RadiationClock(run_dt=1800.0, solar_dt=3600.0)
        return (clk, *step.radiation_refresh(inp, clk.doy, clk.utc_hours,
                                             config=cfg, ict=69, icb=71,
                                             **mods))
    clk, sol, irr = start()
    ref = run(clk, 4, sol, irr)[2]
    clk, sol, irr = start()
    sol, irr, outs = run(clk, 2, sol, irr)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, solar=sol, irrad=irr, clock=clk)
    ck = load_checkpoint(path)
    assert ck["irrad"].flx.device == irr.flx.device
    for f in irr._fields:
        assert torch.equal(getattr(ck["irrad"], f), getattr(irr, f))
    outs += run(ck["clock"], 2, ck["solar"], ck["irrad"])[2]
    for a, b in zip(outs, ref):
        for group in ("sw", "lw"):
            for k in b[group]:
                assert torch.equal(a[group][k], b[group][k]), (group, k)
        assert torch.equal(a["dtdt"], b["dtdt"])


def test_staged_feed_round_trip_on_the_card(dev):
    """put copies the host batch into pinned memory and starts its copy
    on a side stream; get hands it to the current stream."""
    feed = StagedFeed()
    x = {"a": np.arange(4096.0, dtype=np.float32).reshape(1024, 4),
         "b": (torch.arange(1024, dtype=torch.int32),)}
    got = feed.put(x).get()
    assert got["a"].device.type == "cuda"
    assert torch.equal(got["a"].cpu(), torch.from_numpy(x["a"]))
    assert torch.equal(got["b"][0].cpu(), x["b"][0])
    with pytest.raises(RuntimeError, match="before put"):
        feed.get()
    batches = [{"a": np.full((64, 3), float(i), np.float32)}
               for i in range(5)]
    outs = run_steps_overlapped(lambda b: b["a"] * 2.0, batches)
    assert [float(o.sum()) for o in outs] == [i * 384.0 for i in range(5)]


@pytest.mark.parametrize("nshard", [1, 2])
def test_sharded_refresh_equals_unsharded_on_the_card(dev, nshard):
    """The refresh through shard_columns + run_sharded over column_mesh()
    (nshard 1) or two shards on the one card, bitwise equal to the
    unsharded refresh at 64 x 72; K1-K6 launch on the sharded path."""
    inp = example_inputs(64, NLEV, device=dev)
    cfg = RadiationConfig()
    mods = dict(sw=swm.RRTMGSW.from_reference_tables(dev),
                lw=lwm.RRTMGLW.from_reference_tables(dev))

    def refresh(x):
        return step.radiation_refresh(x, DOY, 12.0, config=cfg, ict=69,
                                      icb=71, **mods)
    want = refresh(inp)
    LAUNCHES.clear()
    got = run_sharded(refresh, shard_columns(column_mesh() * nshard, inp))
    assert set(LAUNCHES) == {"mcica_optics_lw", "mcica_optics_sw",
                             "taumol_lw", "rtrnmc", "taumol_sw", "spcvmc"}
    for a, b in zip(got, want):
        for f in b._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def _cosp_scene(device):
    """tests/test_satsim_cosp.py's scene (8 points x 40 levels: a liquid
    deck at 750 hPa with rain below, an ice deck at 300 hPa), numpy."""
    npoints, nlev = 8, 40
    a = np.linspace(0.02, 1.0, nlev + 1) ** 1.3
    ple = np.tile(1e5 * a, (npoints, 1)).astype(np.float32)
    ple[:, 0] = 100.0
    play = 0.5 * (ple[:, 1:] + ple[:, :-1])
    t = np.maximum(292.0 * (play / play[:, -1:]) ** 0.22,
                   205.0).astype(np.float32)
    zle = (-7500.0 * np.log(np.maximum(ple, 1.0) / ple[:, -1:])
           ).astype(np.float32)
    qv = (0.012 * (play / play[:, -1:]) ** 3).astype(np.float32)
    z2 = np.zeros((npoints, nlev), np.float32)
    fcld, ql, qi, qr = z2.copy(), z2.copy(), z2.copy(), z2.copy()
    k_liq = int(np.argmin(abs(play[0] - 75000.0)))
    k_ice = int(np.argmin(abs(play[0] - 30000.0)))
    fcld[:, k_liq], ql[:, k_liq] = 0.6, 1.5e-4
    fcld[:, k_ice], qi[:, k_ice] = 0.3, 2e-5
    qr[:, k_liq:] = 2e-5

    def c(v):
        return np.full((npoints, nlev), v, np.float32)
    arrays = SatsimInputs(
        ple=ple, zle=zle, t=t, qv=qv, fcld=fcld, qi=qi, ql=ql, qr=qr, qs=z2,
        qg=z2, ri=c(30e-6), rl=c(12e-6), rr=c(300e-6), rs=c(100e-6),
        rg=c(150e-6), ts=np.full(npoints, 292.0, np.float32),
        mcosz=np.full(npoints, 0.6, np.float32),
        frland=np.zeros(npoints, np.float32))
    return SatsimInputs(*(torch.as_tensor(x, device=device) for x in arrays))


def _leaves(out, prefix=""):
    for k, v in out.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_cosp_on_the_card_matches_the_cpu(dev):
    """cosp_simulator on the card against the CPU, key 11: frac_out and
    the MODIS phases exact, fill values in the same places, counts
    exact, the other floats <= 5e-5 relmax (meantaucld compared as the
    mean albedo it is a steep function of); no kernel launched."""
    LAUNCHES.clear()
    card = cosp_simulator(threefry.key(11, device=dev), _cosp_scene(dev))
    assert not LAUNCHES
    cpu = dict(_leaves(cosp_simulator(threefry.key(11, device="cpu"),
                                      _cosp_scene("cpu"))))
    fills = torch.tensor([-1.0e30, -999.0, -999.0e-6, -1.0e20])
    for name, a in _leaves(card):
        a, b = a.cpu(), cpu[name]
        if not b.is_floating_point():
            assert torch.equal(a, b), name
            continue
        fa = torch.isin(a, fills) | (a.abs() >= 1e29)
        fb = torch.isin(b, fills) | (b.abs() >= 1e29)
        assert torch.equal(fa, fb), name
        a, b = a[~fb], b[~fb]
        if name.endswith("meantaucld"):
            a, b = [x.double() ** 0.895 / (x.double() ** 0.895 + 6.82)
                    for x in (a, b)]
        if b.numel():
            assert relmax(a, b) <= 5e-5, name


def test_quickbeam_blocks_on_the_card(dev, monkeypatch):
    """The radar's DSD planes in blocks of 3 points (8 points, 50
    subcolumns, 40 levels, every class present) equal the unblocked call
    bit for bit on the card."""
    gen = torch.Generator(dev).manual_seed(0)
    shape = (9, 8, 50, 40)
    z = torch.linspace(16.0, 0.3, 40, device=dev).expand(8, 40)
    p = 1000.0 * torch.exp(-z / 7.5)
    tc = 15.0 - 6.5 * z
    rh = torch.full_like(p, 60.0)
    hm = torch.where(torch.rand(shape, device=dev, generator=gen) < 0.2,
                     torch.rand(shape, device=dev, generator=gen), 0.0)
    re = 300.0 * torch.rand(shape, device=dev, generator=gen)
    plane = 50 * 40 * radar.ND * 4
    monkeypatch.setattr(radar, "PLANE_BYTES", 8 * plane)
    whole = radar.quickbeam_simulator(z, p, tc, rh, hm, re, do_ray=True)
    monkeypatch.setattr(radar, "PLANE_BYTES", 3 * plane)
    parts = radar.quickbeam_simulator(z, p, tc, rh, hm, re, do_ray=True)
    for k in whole:
        assert torch.equal(parts[k], whole[k]), k
