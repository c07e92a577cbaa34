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
facade refresh launches K3, K4, K5 and K10 once each, K8 twice (SW, LW),
K9 twice and nothing else, its states against plain=True at the step's
gates; K10 (both streams of rte_sw) at 8,192 x 72, with and without
aerosol, within the SW kernel gates of its twin (relmax 5e-4, at most
0.5 % of columns beyond 5e-5), sync-free, equal to itself over two runs;
rrtmgp_sw launches it once per captured call, its replays bitwise equal
to the eager body, and plain=True runs the twin, bit for bit the two
rte_sw calls; the
native engine on the card launches K8 twice and nothing else and is
within 5e-5 of the CPU. K8 at 8,100 x 72 bitwise equal to its plain twin
for 112 and 140 g-points, with and without the condensate PDF, sync-free;
rrtmgp_sw / rrtmgp_lw launch it once per captured call. K9 (the LW table
rows) at 8,100 x 72 bitwise equal to its twins for every iceflag and with
and without dudts, sync-free, its wrappers' refusals, and a refresh with
it bitwise equal to the same refresh with the twins' rows (RRTMG and the
RRTMGP facade); the LW solve launches it twice (cloud and Planck rows),
RATS 16 times a refresh, the native engine once. The column
sharding: the refresh over column_mesh() and over two shards on the one
card bitwise equal to the unsharded one, K1-K6 launched; StagedFeed's
round trip through pinned memory and a side stream. The satellite
simulators: cosp_simulator on the card against the CPU (integers exact,
fill values in place, counts exact, floats <= 5e-5, K11 launched once),
K11 (the radar's DSD integrals) at 64 points x 50 subcolumns x 72 levels
against its twin, every class and cosp's five (every class also at 16 and
6 levels), with and without Rayleigh and gas path (dBZe fields within
1e-3 dB where not a fill, fills in place, h_atten relmax <= 1e-4, one
launch a call, sync-free, its counter the twin's count), the twin's point blocks bitwise equal to one unblocked
call, and cosp_simulator captured at 64 points x 50 subcolumns x 72
levels: replays at keys 11 and 12 bitwise equal to the eager body under
disable_capture(), one graph for the key, K11 once a call, both under
set_sync_debug_mode("error"), a key off the inputs' device refused. The captured
step entries at 64 x 72: replays bitwise equal to the eager bodies at two
doy values and on two scenes, K1-K6 counted once per replay, outputs of
successive calls sharing no storage, a replay and the eager bodies
under set_sync_debug_mode("error"), and a new shape captured anew. The
captured scheme entries at 64 x 72 (rrtmg_lw, rrtmg_sw, chou_sw,
chou_lw, rrtmgp_sw, rrtmgp_lw): replays bitwise equal to their _eager
bodies at two doy values (Chou: on two scenes), one graph per key, the
launches of the eager body once per replay; radiation_refresh under
Chou/Chou, RRTMGP/RRTMGP, the native engine and RRTMG SW + Chou LW
(48 x 72) replayed bitwise equal to radiation_refresh_eager under
disable_capture(); rats_refresh's replays bitwise equal to its eager
run; each replay and eager body under set_sync_debug_mode("error"); the
step refresh's capture records no rrtmg_lw / rrtmg_sw graph.
"""

import os
import sys

import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu_torch.config import RadiationConfig, Scheme
from geosradiation_gridcomp_tpu_torch.driver import radiation as rad
from geosradiation_gridcomp_tpu_torch.driver import step
from geosradiation_gridcomp_tpu_torch.driver.astronomy import \
    mean_cos_zenith
from geosradiation_gridcomp_tpu_torch.driver.checkpoint import (
    load_checkpoint, save_checkpoint)
from geosradiation_gridcomp_tpu_torch.driver.clock import RadiationClock
from geosradiation_gridcomp_tpu_torch.driver.compiled import disable_capture
from geosradiation_gridcomp_tpu_torch.driver.diagnostics import (
    RATS_GASES, rats_refresh, rats_update)
from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
from geosradiation_gridcomp_tpu_torch.kernels.twins import twins
from geosradiation_gridcomp_tpu_torch.models import chou_lw as chou_lw_mod
from geosradiation_gridcomp_tpu_torch.models import chou_sw as chou_sw_mod
from geosradiation_gridcomp_tpu_torch.models.rrtmg import lw as lwm
from geosradiation_gridcomp_tpu_torch.models.rrtmg import lw_rows_cuda
from geosradiation_gridcomp_tpu_torch.models.rrtmg import sw as swm
from geosradiation_gridcomp_tpu_torch.models.rrtmg.cldprmc_lw import \
    band_abs_coeffs_lw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.cldprmc_sw import \
    CloudPackSW
from geosradiation_gridcomp_tpu_torch.models.rrtmg.rtrnmc import rtrnmc
from geosradiation_gridcomp_tpu_torch.models.rrtmg.rtrnmc_cuda import \
    rtrnmc_fast
from geosradiation_gridcomp_tpu_torch.models.rrtmg.setcoef_lw import (
    planck_rows_plain, setcoef_lw)
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
from geosradiation_gridcomp_tpu_torch.models.rrtmgp import scheme as gp
from geosradiation_gridcomp_tpu_torch.models.rrtmgp.rte import rte_sw
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
from geosradiation_gridcomp_tpu_torch.satsim import (SatsimConfig,
                                                     SatsimInputs,
                                                     cosp_simulator, radar)
from geosradiation_gridcomp_tpu_torch.satsim import cosp as cosp_mod
from geosradiation_gridcomp_tpu_torch.scene import example_inputs

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import satsim_inputs  # noqa: E402
from torch_radar_args import radar_arrays  # noqa: E402

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
    assert LAUNCHES["lw_rows"] == 2             # K9: cloud and Planck rows
    with twins():
        ref = rad.irrad_refresh(inp, DOY, cfg, 69, 71, lw=case["lw"])
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
    assert LAUNCHES["lw_rows"] == 2
    sol_p, irr_p = step.radiation_refresh(inp, DOY, 12.0, plain=True, **kw)
    for f in irr._fields:
        assert relmax(getattr(irr, f), getattr(irr_p, f)) <= 5e-5, f
    for f in sol._fields:
        assert relmax(getattr(sol, f), getattr(sol_p, f)) <= 5e-4, f


def test_rrtmgp_refresh_runs_k3_k4_k5(case):
    """The RRTMGP facade: K3, K4, K5 and K10 once each per refresh, K8
    twice (SW, LW) and K9 twice (the Planck rows of its gas optics, the
    cloud rows of its band cloud optics), no other kernel; the states
    against plain=True at the step's gates."""
    cfg = RadiationConfig(sw_scheme=Scheme.RRTMGP, lw_scheme=Scheme.RRTMGP)
    kw = dict(config=cfg, ict=69, icb=71, sw=case["sw"], lw=case["lw"])
    LAUNCHES.clear()
    sol, irr = step.radiation_refresh(case["inp"], DOY, 12.0, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"taumol_lw": 1, "rtrnmc": 1, "taumol_sw": 1,
                              "mcica_gmr": 2, "lw_rows": 2, "rte_sw": 1}
    sol_p, irr_p = step.radiation_refresh(case["inp"], DOY, 12.0,
                                          plain=True, **kw)
    for f in irr._fields:
        assert relmax(getattr(irr, f), getattr(irr_p, f)) <= 5e-5, f
    for f in sol._fields:
        assert relmax(getattr(sol, f), getattr(sol_p, f)) <= 5e-4, f


@pytest.mark.parametrize("ngpt", [112, 140])
def test_k8_equals_plain_at_c90(dev, ngpt):
    """K8 at 8,100 x 72 (a C90 face) bitwise equal to its plain twin,
    with the condensate PDF (inhm 1) and without (inhm 0), one launch a
    call, the kernel's route under set_sync_debug_mode("error")."""
    inp = example_inputs(8100, NLEV, seed=5, device=dev)
    play = rad._common_derived(inp)[0]
    zm = lwm.mid_heights(play, inp.t, inp.ple[..., -1])
    lw = rad.reference_modules(dev)[1]
    for cols in (lw.zcw_cols(1), None):
        args = (play, zm, inp.lats, DOY, inp.fcld, ngpt, cols)
        LAUNCHES.clear()
        (got,) = _sync_free(lambda: gp._gen_max_ran_mask(*args))
        with twins():
            want = gp._gen_max_ran_mask(*args)
        assert dict(LAUNCHES) == {"mcica_gmr": 1}
        assert got[0].shape == (8100, NLEV, ngpt)
        assert bool(want[0].any()) and not bool(want[0].all())
        for a, b in zip(got, want):
            assert torch.equal(a, b), (ngpt, cols is None)


@pytest.mark.parametrize("name", ["rrtmgp_sw", "rrtmgp_lw"])
def test_rrtmgp_entry_launches_k8_once_a_call(dev, name):
    """Each captured rrtmgp_sw / rrtmgp_lw call, replayed, adds exactly
    one K8 launch, and its replays are bitwise equal to the eager body,
    under set_sync_debug_mode("error"). 56 columns: a key no other test
    captures."""
    entry, body, a, kw, _ = _scheme_calls(dev, 0, (None, None), ncol=56)[
        name]
    a = (*a, DOY)
    before = len(entry.graphs)
    entry(*a, **kw)                                 # warm-up + capture
    assert len(entry.graphs) == before + 1
    for calls in (1, 2):
        LAUNCHES.clear()
        got = _sync_free(*[lambda: entry(*a, **kw)] * calls)
        assert LAUNCHES["mcica_gmr"] == calls
    LAUNCHES.clear()
    (want,) = _sync_free(lambda: body(*a, **kw))
    assert LAUNCHES["mcica_gmr"] == 1
    for k in want:
        assert torch.equal(got[-1][k], want[k]), (name, k)


def _k10_inputs(dev, ncol, aerosol):
    """rte_sw_fast's arguments as rrtmgp_sw_eager gives them at ncol x 72
    (scene seed 5, the refresh's cos zenith: night columns included),
    recorded on the eager body; with aerosol, optics drawn uniformly
    (tau 0-0.2, ssa 0.8-1, g 0.5-0.8) for every band."""
    _, body, a, kw, _ = _scheme_calls(dev, 5, (None, None), ncol=ncol)[
        "rrtmgp_sw"]
    seen = []
    saved = gp.rte_sw_fast
    gp.rte_sw_fast = lambda *x, **k: seen.append(x) or saved(*x, **k)
    try:
        with twins():
            body(*a, DOY, **kw)
    finally:
        gp.rte_sw_fast = saved
    (args,) = seen
    assert float(args[6].min()) <= 0.0 < float(args[6].max())
    if not aerosol:
        return args, {}
    gen = torch.Generator(device=dev).manual_seed(22)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(
        (ncol, NLEV, 14), generator=gen, device=dev)
    return args, dict(tau_aer=u(0.0, 0.2), ssa_aer=u(0.8, 1.0),
                      g_aer=u(0.5, 0.8))


@pytest.mark.parametrize("aerosol", [False, True])
def test_k10_matches_plain_at_8192(dev, aerosol):
    """K10 at 8,192 x 72 against its twin (rte_sw all-sky, then rte_sw
    with zero cloud optics) within the SW kernel gates: relmax <= 5e-4
    and at most 0.5 % of columns beyond 5e-5, every profile; one launch
    a call, the kernel's route under set_sync_debug_mode("error"), equal
    to itself over two runs."""
    args, aero = _k10_inputs(dev, 8192, aerosol)
    LAUNCHES.clear()
    got, again = _sync_free(lambda: gp.rte_sw_fast(*args, **aero),
                            lambda: gp.rte_sw_fast(*args, **aero))
    assert dict(LAUNCHES) == {"rte_sw": 2}
    with twins():
        want = gp.rte_sw_fast(*args, **aero)
    assert dict(LAUNCHES) == {"rte_sw": 2}
    for sky, a, b, c in zip(("allsky", "clrsky"), got, want, again):
        assert sorted(a) == sorted(b)
        for k in b:
            assert torch.equal(a[k], c[k]), (sky, k)
            assert relmax(a[k], b[k]) <= 5e-4, (sky, k)
            err = (a[k].double() - b[k].double()).abs().max(dim=1).values
            share = float((err > 5e-5 * float(b[k].abs().max()))
                          .double().mean())
            assert share <= 5e-3, (sky, k, share)


def test_rrtmgp_sw_launches_k10_once_a_call(dev):
    """Each captured rrtmgp_sw call, replayed, adds exactly one K10
    launch, and its replays are bitwise equal to the eager body, under
    set_sync_debug_mode("error"); plain=True launches none and runs the
    twin, bit for bit the two rte_sw calls the body made before K10. 57
    columns: a key no other test captures."""
    entry, body, a, kw, _ = _scheme_calls(dev, 0, (None, None), ncol=57)[
        "rrtmgp_sw"]
    a = (*a, DOY)
    entry(*a, **kw)                                 # warm-up + capture
    for calls in (1, 2):
        LAUNCHES.clear()
        got = _sync_free(*[lambda: entry(*a, **kw)] * calls)
        assert LAUNCHES["rte_sw"] == calls
    LAUNCHES.clear()
    (want,) = _sync_free(lambda: body(*a, **kw))
    assert LAUNCHES["rte_sw"] == 1
    for k in want:
        assert torch.equal(got[-1][k], want[k]), k

    def two_calls(taug, taur, tau_cld, ssa, g, *rest, **aero):
        zero = torch.zeros_like(tau_cld)
        return (rte_sw(taug, taur, tau_cld, ssa, g, *rest, **aero),
                rte_sw(taug, taur, zero, zero, zero, *rest, **aero))
    LAUNCHES.clear()
    plain = entry(*a, plain=True, **kw)
    assert "rte_sw" not in LAUNCHES
    saved = gp.rte_sw_fast
    gp.rte_sw_fast = two_calls
    try:
        before = body(*a, plain=True, **kw)
    finally:
        gp.rte_sw_fast = saved
    for k in before:
        assert torch.equal(plain[k], before[k]), k


def test_rrtmgp_native_on_the_card_matches_the_cpu(dev, tmp_path):
    """RRTMGP through the native engine (chip_smoke's synthetic 2-band
    set) on the card: K8 launched twice (SW, LW), K9 once (the cloud rows
    of the band cloud optics) and no other kernel, within 5e-5 of the
    CPU."""
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
        assert dict(LAUNCHES) == ({"mcica_gmr": 2, "lw_rows": 1}
                                  if device == dev else {})
        outs.append((sol, irr, upd))
    (sol, irr, upd), (sol_c, irr_c, upd_c) = outs
    assert tuple(irr.olrb.shape) == (64, 2)
    for a, b in ((sol, sol_c), (irr, irr_c)):
        for f in a._fields:
            assert relmax(getattr(a, f).cpu(), getattr(b, f)) <= 5e-5, f
    for group in ("sw", "lw"):
        for k in upd_c[group]:
            assert relmax(upd[group][k].cpu(), upd_c[group][k]) <= 5e-5, k


def _c90_face(dev, seed=5):
    """A C90 face, 8,100 x 72: the inputs, the level temperatures, the
    LW surface emissivity [8100, 16] and the LW tables."""
    inp = example_inputs(8100, NLEV, seed=seed, device=dev)
    play = rad._common_derived(inp)[0]
    tlev = lwm.level_temperatures(play, inp.t, inp.ple * 0.01, inp.tsinst)
    emis = inp.emis[:, None].expand(8100, 16).contiguous()
    return inp, tlev, emis, rad.reference_modules(dev)[1]


@pytest.mark.parametrize("iceflag", [0, 1, 2, 3, 4])
def test_k9_cloud_rows_equal_plain_at_c90(dev, iceflag):
    """K9's cloud rows at 8,100 x 72 bitwise equal to band_abs_coeffs_lw's
    plain body, on the scene's radii and on radii below and above the
    tables, one launch a call (absliq alone for iceflags 0 and 1), the
    route under set_sync_debug_mode("error")."""
    inp, _, _, lw = _c90_face(dev)
    rei, rel = inp.ri.clone(), inp.rl.clone()
    rei[0, :8] = torch.tensor([0.0, 1.0, 4.99, 5.0, 8.0, 137.0, 138.0, 500.0],
                              device=dev)
    rel[0, :8] = torch.tensor([0.0, 2.49, 2.5, 3.5, 58.5, 59.0, 60.0, 300.0],
                              device=dev)
    tables = lw.cloud_tables
    # the twin first: iceflag 1's band map is copied to the card at its
    # first use on a device (tables.on_device), which synchronises
    with twins():
        want = band_abs_coeffs_lw(rei, rel, tables, iceflag=iceflag)
    LAUNCHES.clear()
    (got,) = _sync_free(lambda: band_abs_coeffs_lw(rei, rel, tables,
                                                   iceflag=iceflag))
    assert dict(LAUNCHES) == {"lw_rows": 1}
    for a, b in zip(got, want):
        assert a.shape == b.shape == (8100, NLEV, 16)
        assert torch.equal(a, b), iceflag


@pytest.mark.parametrize("dudts", [True, False])
def test_k9_planck_rows_equal_plain_at_c90(dev, dudts):
    """K9's Planck rows at 8,100 x 72 bitwise equal to planck_rows_plain,
    temperatures below 160 K and above 340 K included, one launch a call,
    sync-free; and setcoef_lw with them bitwise equal to setcoef_lw under
    twins() in every field."""
    inp, tlev, emis, lw = _c90_face(dev)
    edges = torch.tensor([100.0, 159.5, 160.0, 161.0, 339.0, 339.5, 340.0,
                          400.0], device=dev)
    tavel, tz, ts = inp.t.clone(), tlev.clone(), inp.tsinst.clone()
    tavel[0, :8], tz[1, :8], ts[:8] = edges, edges, edges
    tables = lw.planck_tables
    LAUNCHES.clear()
    (got,) = _sync_free(lambda: lw_rows_cuda.planck_rows(
        tavel, tz, ts, emis, tables["totplnk"], tables["totplnkderiv"],
        dudts))
    assert dict(LAUNCHES) == {"lw_rows": 1}
    want = planck_rows_plain(tavel, tz, ts, emis, tables, dudts)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    assert bool(got[1].any()) == dudts
    play, h2o, o3 = rad._common_derived(inp)
    z = torch.zeros_like(inp.co2)
    args = (play, tavel, inp.ple * 0.01, tz, ts, emis, h2o, o3, inp.co2,
            inp.ch4, inp.n2o, torch.full_like(z, 0.2095), z, inp.cfc11,
            inp.cfc12, inp.hcfc22, z, tables)
    a = setcoef_lw(*args, dudts=dudts)
    with twins():
        b = setcoef_lw(*args, dudts=dudts)
    for f in b._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("scheme", ["rrtmg", "rrtmgp"])
def test_refresh_with_k9_bitwise_equal_to_its_twins(case, monkeypatch,
                                                    scheme):
    """A refresh run with K9 is bitwise equal to the same refresh with the
    LW table rows from K9's plain twins and every other kernel as it was
    (the bodies, run op by op): K9 moves no number of the RRTMG step or
    of the RRTMGP facade."""
    from geosradiation_gridcomp_tpu_torch.models.rrtmgp import kdist
    cfg = RadiationConfig() if scheme == "rrtmg" else RadiationConfig(
        sw_scheme=Scheme.RRTMGP, lw_scheme=Scheme.RRTMGP)

    def refresh():
        with disable_capture():
            return step.radiation_refresh_eager(
                case["inp"], DOY, 12.0, config=cfg, ict=69, icb=71,
                sw=case["sw"], lw=case["lw"])
    LAUNCHES.clear()
    got = refresh()
    assert LAUNCHES["lw_rows"] == 2
    def twin(fn):
        def run(*a, **kw):
            with twins():
                return fn(*a, **kw)
        return run
    for mod in (lwm, kdist, gp):
        for name in ("band_abs_coeffs_lw", "setcoef_lw"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, twin(getattr(mod, name)))
    LAUNCHES.clear()
    want = refresh()
    assert "lw_rows" not in LAUNCHES and LAUNCHES["taumol_lw"] == 1
    for a, b in zip(_step_tensors(got), _step_tensors(want)):
        assert torch.equal(a, b), scheme


def _off16(t):
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def test_k9_wrappers_refuse_what_the_kernel_does_not_take(case):
    """Tensors off the card, of another dtype, not contiguous or of
    mismatched shapes, tables of another width or (Planck) another row
    count, and rows it reads as float4 (tables, semiss) not 16-byte
    aligned, are refused."""
    inp, lw = case["inp"], case["lw"]
    ct, pt = lw.cloud_tables, lw.planck_tables
    rei, rel = inp.ri.contiguous(), inp.rl.contiguous()
    ice, liq = ct["absice3"], ct["absliq1"]
    cloud = lw_rows_cuda.cloud_rows
    for bad, err in (((rei.cpu(), rel.cpu(), ice.cpu(), liq.cpu()),
                      ValueError),
                     ((rei.double(), rel.double(), ice, liq), TypeError),
                     ((rei.t(), rel.t(), ice, liq), ValueError),
                     ((rei[:, 1:].contiguous(), rel, ice, liq), ValueError),
                     ((rei, rel, ice[:, :14].contiguous(), liq),
                      ValueError),
                     ((rei, rel, ice, _off16(liq)), ValueError)):
        with pytest.raises(err):
            cloud(*bad)
    tz = lwm.level_temperatures(case["k1"][0], inp.t, inp.ple * 0.01,
                                inp.tsinst)
    tabs = (pt["totplnk"], pt["totplnkderiv"])
    emis = case["emis"]
    for bad, err in (((inp.t, tz[:, 1:].contiguous(), inp.tsinst, emis,
                       *tabs), ValueError),
                     ((inp.t, tz, inp.tsinst, emis[:, :8].contiguous(),
                       *tabs), ValueError),
                     ((inp.t, tz, inp.tsinst, emis, pt["totplnk"][1:],
                       pt["totplnkderiv"][1:]), ValueError),
                     ((inp.t, tz, inp.tsinst, emis.double(), *tabs),
                      TypeError),
                     ((inp.t, tz, inp.tsinst, _off16(emis), *tabs),
                      ValueError)):
        with pytest.raises(err):
            lw_rows_cuda.planck_rows(*bad)


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
    """RATS at 64 x 72 with the kernels (its 8 solves replay one captured
    rrtmg_lw graph), through the eager bodies with K3's inputs of each
    solve kept (a replay calls no wrapper), and with the twins."""
    inp = example_inputs(64, NLEV, device=dev)
    lw = lwm.RRTMGLW.from_reference_tables(dev)
    cfg = RadiationConfig()
    k3_calls = []

    def k3_recorded(*args, **kwargs):
        k3_calls.append((args, kwargs))
        return taumol_lw_fast(*args, **kwargs)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    kern = rats_refresh(inp, DOY, cfg, 69, 71, lw=lw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    lwm.taumol_lw_fast = k3_recorded
    try:
        with disable_capture():
            eager = rats_refresh(inp, DOY, cfg, 69, 71, lw=lw)
    finally:
        lwm.taumol_lw_fast = taumol_lw_fast
    with twins():
        plain = rats_refresh(inp, DOY, cfg, 69, 71, lw=lw)
    return inp, lw, kern, plain, launches, k3_calls, eager


def test_rats_launches_each_lw_kernel_once_per_gas(rats):
    """K1, K3 and K4 once per gas; K9 twice (cloud and Planck rows)."""
    launches = rats[4]
    for k in ("mcica_optics_lw", "taumol_lw", "rtrnmc"):
        assert launches.get(k) == len(RATS_GASES), (k, launches)
    assert launches.get("lw_rows") == 2 * len(RATS_GASES), launches


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
    kern, plain = rats[2], rats[3]
    g = RATS_GASES.index(gas)
    for f in kern._fields:
        assert relmax(getattr(kern, f)[g], getattr(plain, f)[g]) <= 5e-5, f


def test_rats_forcing_on_the_card(rats):
    inp, lw, kern = rats[:3]
    irr = rad.irrad_refresh(inp, DOY, RadiationConfig(), 69, 71, lw=lw)
    _, forcing = rats_update(kern, irr, inp.tsinst + 0.5)
    toa = forcing[:, :, 0]
    co2, ch4 = toa[RATS_GASES.index("CO2")], toa[RATS_GASES.index("CH4")]
    assert float(co2.mean()) > float(ch4.mean()) > 0.0


def test_rats_ranges_and_counts_on_the_card_do_not_synchronise(rats):
    """Two RATS refreshes and an update, profiled and not, under
    set_sync_debug_mode("error"): the ranges only under the profiler,
    counts() up by 2 calls, 16 solves, 16 fills and 80 copies, every
    output bitwise the replay's of the fixture."""
    from torch.profiler import ProfilerActivity, profile
    from geosradiation_gridcomp_tpu_torch.driver.diagnostics import counts
    inp, lw, kern = rats[:3]
    cfg = RadiationConfig()
    irr = rad.irrad_refresh(inp, DOY, cfg, 69, 71, lw=lw)
    ts = inp.tsinst + 0.5
    torch.cuda.synchronize()
    before = counts()
    outs = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            traced = rats_refresh(inp, DOY, cfg, 69, 71, lw=lw)
            outs.append(rats_update(traced, irr, ts))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.set_sync_debug_mode("error")
    try:
        plain = rats_refresh(inp, DOY, cfg, 69, 71, lw=lw)
        outs.append(rats_update(plain, irr, ts))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    after = counts()
    names = {e.name for e in prof.events()}
    want = {f"rats_refresh/{g}" for g in RATS_GASES} | {
        "rats_refresh/stack", "rats_update"}
    assert want <= names
    assert {k: after["rats_refresh"][k] - before["rats_refresh"][k]
            for k in before["rats_refresh"]} == dict(
        calls=2, solves=16, fills=16, copies=80)
    assert after["rats_update"]["calls"] - before["rats_update"][
        "calls"] == 2
    for x, y, z in zip(traced, plain, kern):
        assert torch.equal(x, z) and torch.equal(y, z)
    for x, y in zip(*outs):
        assert torch.equal(x, y)


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
                             "taumol_lw", "rtrnmc", "taumol_sw", "spcvmc",
                             "lw_rows"}
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
    mean albedo it is a steep function of); K11, the radar, launched once
    and no other kernel."""
    LAUNCHES.clear()
    card = cosp_simulator(threefry.key(11, device=dev), _cosp_scene(dev))
    assert dict(LAUNCHES) == {"quickbeam": 1}
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


@pytest.fixture(scope="module")
def radar_case(dev):
    """The radar's arguments on the card at 64 points x 50 subcolumns x 72
    levels: tests/torch_radar_args.py:radar_arrays (all 9 classes) with point 0's
    top five levels at -100 C, point 1's lowest five at 30 C and rain in
    every subcolumn of point 2 at levels 30-37 (K11's dense levels), and
    the five-class call cosp_simulator_eager makes on chip_smoke's satsim
    scene (no graupel)."""
    args = [torch.as_tensor(a, device=dev)
            for a in radar_arrays(64, 50, NLEV)]
    args[2][0, :5], args[2][1, -5:] = -100.0, 30.0
    args[4][2, 2, :, 30:38] = 0.5
    seen, saved = [], cosp_mod.quickbeam_simulator
    cosp_mod.quickbeam_simulator = lambda *a, **k: seen.append((a, k)) or \
        saved(*a, **k)
    try:
        cosp_mod.cosp_simulator_eager(threefry.key(5, device=dev),
                                      satsim_inputs(torch, 64, dev))
    finally:
        cosp_mod.quickbeam_simulator = saved
    (a, k), = seen
    return {"all": (args, tuple(range(9))),
            "cosp": ([x.contiguous() for x in a], k["classes"])}


@pytest.mark.parametrize("which,nlev", [("all", NLEV), ("cosp", NLEV),
                                        ("all", 16), ("all", 6)])
@pytest.mark.parametrize("do_ray,use_gas_abs", [(False, True), (True, True),
                                                (False, False)])
def test_k11_matches_plain_on_the_card(radar_case, which, nlev, do_ray,
                                       use_gas_abs):
    """K11 at 64 points x 50 subcolumns x 72 levels against its twin
    (quickbeam_simulator under twins()), and at the top 16 and 6 levels
    (blocks of 64 and 32 threads, fewer than the 9 classes' 81
    parameters): the same keys and shapes; dbze, ze_non and ze_ray within
    1e-3 dB where not a fill and the fills in the same places; h_atten
    relmax <= 1e-4; g_atten the twin's; one launch a call, sync-free,
    equal to itself over two runs; its counter the twin's count of present
    (volume, class) pairs."""
    args, classes = radar_case[which]
    args = [a[..., :nlev].contiguous() for a in args]
    kw = dict(do_ray=do_ray, use_gas_abs=use_gas_abs, classes=classes)
    radar.quickbeam_simulator(*args, **kw)        # tables to the card
    LAUNCHES.clear()
    got, again = _sync_free(*[lambda: radar.quickbeam_simulator(*args, **kw)]
                            * 2)
    assert dict(LAUNCHES) == {"quickbeam": 2}
    with twins():
        want = radar.quickbeam_simulator(*args, **kw)
    assert dict(LAUNCHES) == {"quickbeam": 2}
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], again[k]), k
    for k in ("dbze", "ze_non") + (("ze_ray",) if do_ray else ()):
        fill = want[k] == radar.MISSING_DBZ
        assert torch.equal(got[k] == radar.MISSING_DBZ, fill), k
        assert float((got[k] - want[k])[~fill].abs().max()) <= 1e-3, k
    assert relmax(got["h_atten"], want["h_atten"]) <= 1e-4
    assert torch.equal(got["g_atten"], want["g_atten"])
    radar.quickbeam_simulator(*args, **kw)
    hm = args[4]
    assert radar.counts()[(classes, tuple(hm.shape[1:]), "torch.float32")][
        "present"] == int((hm > 1e-12).sum())


def test_quickbeam_blocks_on_the_card(dev, monkeypatch):
    """The radar's twin, its DSD planes in blocks of 3 points (8 points,
    50 subcolumns, 40 levels, every class present), equals the unblocked
    call bit for bit on the card."""
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
    with twins():
        whole = radar.quickbeam_simulator(z, p, tc, rh, hm, re, do_ray=True)
        monkeypatch.setattr(radar, "PLANE_BYTES", 3 * plane)
        parts = radar.quickbeam_simulator(z, p, tc, rh, hm, re, do_ray=True)
    for k in whole:
        assert torch.equal(parts[k], whole[k]), k


def test_cosp_replays_bitwise_equal_eager(dev):
    """cosp_simulator at 64 points x 50 subcolumns x 72 levels (chip_smoke's
    satsim scene, graupel in the snow's levels) captured once: replays at
    keys 11 and 12 bitwise equal to the eager body under
    disable_capture() (and the two keys' outputs not equal: the key is
    traced), one graph for config None and SatsimConfig(), K11 launched
    once a call and no other kernel, replay and eager body under
    set_sync_debug_mode("error");
    a key on the CPU with inputs on the card is refused."""
    inp = satsim_inputs(torch, 64, dev)
    inp = inp._replace(qg=0.5 * inp.qs)
    keys = [threefry.key(s, device=dev) for s in (11, 12)]
    before = len(cosp_simulator.graphs)
    cosp_simulator(keys[0], inp)                    # warm-up + capture
    assert len(cosp_simulator.graphs) == before + 1
    outs = []
    for key in keys:
        LAUNCHES.clear()

        def eager(key=key):
            with disable_capture():
                return cosp_simulator(key, inp)
        got, want = _sync_free(
            lambda: cosp_simulator(key, inp, SatsimConfig()), eager)
        assert dict(LAUNCHES) == {"quickbeam": 2}
        want = dict(_leaves(want))
        for name, a in _leaves(got):
            assert a.dtype == want[name].dtype, name
            assert torch.equal(a, want[name]), name
        outs.append(got)
    assert len(cosp_simulator.graphs) == before + 1
    assert not torch.equal(outs[0]["frac_out"], outs[1]["frac_out"])
    with pytest.raises(ValueError, match="lie on"):
        cosp_simulator(keys[0].cpu(), inp)


STEP_KERNELS = ("mcica_optics_lw", "mcica_optics_sw", "taumol_lw", "rtrnmc",
                "taumol_sw", "spcvmc")


def step_launches(n):
    """The launches of n step refreshes: each step kernel once, K9 twice
    (the LW cloud rows and the Planck rows)."""
    return dict(dict.fromkeys(STEP_KERNELS, n), lw_rows=2 * n)


def _step_tensors(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _step_tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _step_tensors(x)]
    return [tree]


@pytest.fixture(scope="module")
def captured_step(dev):
    """refresh + update at 64 x 72 with packing, through the captured
    entries or the eager bodies, on the scene of a seed."""
    cfg = RadiationConfig()
    mods = dict(sw=swm.RRTMGSW.from_reference_tables(dev),
                lw=lwm.RRTMGLW.from_reference_tables(dev))
    scenes = {s: example_inputs(64, NLEV, seed=s, device=dev) for s in (0, 1)}
    bounds = step.sw_partition_bounds(scenes[0].lons, scenes[0].lats,
                                      scenes[0].fcld, DOY, 12.0, cfg,
                                      bucket=8)

    def run(seed=0, doy=DOY, eager=False, ncol=64):
        inp = scenes[seed]
        if ncol != 64:
            inp = type(inp)(*(x[:ncol] for x in inp))
        refresh, update = ((step.radiation_refresh_eager,
                            step.radiation_update_eager) if eager
                           else (step.radiation_refresh,
                                 step.radiation_update))
        sol, irr = refresh(inp, doy, 12.0, config=cfg, ict=69, icb=71,
                           sw_nlit=bounds[0], sw_ncld=bounds[1], **mods)
        upd = update(sol, irr, inp.tsinst + 0.5, inp.lons, inp.lats, inp.ple,
                     doy, 12.25, config=cfg)
        return sol, irr, upd
    return run


def test_captured_step_bitwise_equals_eager(captured_step):
    """The replays at two doy values (the second not the one captured) and
    on two scenes are bitwise equal to the eager bodies."""
    for seed in (0, 1):
        for doy in (DOY, DOY + 0.001):
            got = captured_step(seed, doy)
            want = captured_step(seed, doy, eager=True)
            for a, b in zip(_step_tensors(got), _step_tensors(want)):
                assert torch.equal(a, b), (seed, doy)


def test_captured_step_counts_each_kernel_once_per_replay(captured_step):
    captured_step()
    for n in (1, 2):
        LAUNCHES.clear()
        for _ in range(n):
            captured_step(doy=DOY + 0.5)
        torch.cuda.synchronize()
        assert dict(LAUNCHES) == step_launches(n)


def test_captured_step_outputs_do_not_alias(captured_step):
    a, b = captured_step(0), captured_step(1)
    mine = [t.untyped_storage().data_ptr() for t in _step_tensors((a, b))]
    assert len(set(mine)) == len(mine)
    # the first call's states are the seed-0 results still
    for x, y in zip(_step_tensors(a), _step_tensors(captured_step(0, eager=True))):
        assert torch.equal(x, y)


def test_captured_step_does_not_synchronise(captured_step):
    """A replayed refresh + update, and the eager bodies, under
    set_sync_debug_mode("error"): no copy from host memory, no read of a
    device value."""
    captured_step()
    captured_step(eager=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        captured_step(doy=DOY + 0.25)
        captured_step(doy=DOY + 0.25, eager=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_a_new_key_captures_anew(captured_step):
    refresh = step.radiation_refresh
    captured_step()
    before = len(refresh.graphs)
    got = captured_step(ncol=56)
    assert len(refresh.graphs) == before + 1
    for a, b in zip(_step_tensors(got), _step_tensors(captured_step(eager=True,
                                                        ncol=56))):
        assert torch.equal(a, b)
    captured_step(ncol=56)
    assert len(refresh.graphs) == before + 1


# --------------------------------------------------------------------------
# the captured scheme entries
# --------------------------------------------------------------------------

def _sync_free(*fns):
    """Run fns under set_sync_debug_mode("error"); returns their
    results."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return [fn() for fn in fns]
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def _sw_bounds(dev, seeds):
    """The SW packing bounds that hold for the scenes of seeds at 64 x 72
    (the larger of each), as bench.py takes them over its doy range."""
    bounds = [step.sw_partition_bounds(
        x.lons, x.lats, x.fcld, DOY, 12.0, RadiationConfig(), bucket=8)
        for x in (example_inputs(64, NLEV, seed=s, device=dev)
                  for s in seeds)]
    return tuple(None if any(b[i] is None for b in bounds)
                 else max(b[i] for b in bounds) for i in (0, 1))


def _scheme_calls(dev, seed, bounds, ncol=64):
    """name -> (entry, eager body, positional args before doy, keyword
    args, takes doy) at ncol x 72 on the scene of seed, the refresh's
    cos zenith and rrtmg_sw packed to bounds (nlit, ncld)."""
    inp = example_inputs(ncol, NLEV, seed=seed, device=dev)
    sw, lw = rad.reference_modules(dev)
    play, h2o, o3 = rad._common_derived(inp)
    z = torch.zeros_like(inp.co2)
    o2 = torch.full_like(z, 0.2095)
    tlev = lwm.level_temperatures(play, inp.t, inp.ple * 0.01, inp.tsinst)
    zm = lwm.mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = rad._incloud_paths(inp)
    slr, lit = mean_cos_zenith(inp.lons, inp.lats, DOY, 12.0, 1.0)
    cosz = torch.where(lit > 0.0, slr / torch.clamp(lit, min=1e-6),
                       torch.zeros_like(slr))
    emis16 = inp.emis[:, None].expand(ncol, 16)
    cwc, reff = rad._cwc_reff(inp)
    cloud = (inp.fcld, ciwp, clwp, inp.ri, inp.rl, zm, inp.lats)
    sw_args = (inp.ple, play, inp.t, cosz, inp.albvr, inp.albvf, inp.albnr,
               inp.albnf, h2o, o3, inp.co2, inp.ch4, o2, *cloud)
    ict = dict(cloud_mh=69, cloud_lm=71)
    return {
        "rrtmg_lw": (lwm.rrtmg_lw, lwm.rrtmg_lw_eager,
                     (lw, inp.ple, play, inp.t, tlev, inp.tsinst, emis16,
                      h2o, o3, inp.co2, inp.ch4, inp.n2o, o2, z, inp.cfc11,
                      inp.cfc12, inp.hcfc22, z, *cloud), ict, True),
        "rrtmg_sw": (swm.rrtmg_sw, swm.rrtmg_sw_eager, (sw, *sw_args),
                     dict(ict, nlit=bounds[0], ncld=bounds[1]), True),
        "chou_sw": (chou_sw_mod.chou_sw, chou_sw_mod.chou_sw_eager,
                    (cosz, inp.ple, inp.t, inp.qv, inp.o3, inp.co2, cwc,
                     inp.fcld, reff),
                    dict(rsuvbm=inp.albvr, rsuvdf=inp.albvf,
                         rsirbm=inp.albnr, rsirdf=inp.albnf, ict=69,
                         icb=71), False),
        "chou_lw": (chou_lw_mod.chou_lw, chou_lw_mod.chou_lw_eager,
                    (inp.ple, inp.t, inp.qv, inp.o3, inp.t2m, inp.tsinst,
                     inp.emis[:, None].expand(ncol, 10), inp.co2, inp.n2o,
                     inp.ch4, inp.cfc11, inp.cfc12, inp.hcfc22, cwc,
                     inp.fcld, reff), dict(ict=69, icb=71), False),
        "rrtmgp_sw": (gp.rrtmgp_sw, gp.rrtmgp_sw_eager, (sw, *sw_args), {},
                      True),
        "rrtmgp_lw": (gp.rrtmgp_lw, gp.rrtmgp_lw_eager,
                      (lw, inp.ple, play, inp.t, inp.tsinst, emis16, h2o,
                       o3, inp.co2, inp.ch4, inp.n2o, o2, inp.cfc11,
                       inp.cfc12, inp.hcfc22, *cloud), {}, True)}


@pytest.mark.parametrize("name", ["rrtmg_lw", "rrtmg_sw", "chou_sw",
                                  "chou_lw", "rrtmgp_sw", "rrtmgp_lw"])
def test_scheme_entry_replays_bitwise_equal_eager(dev, name):
    """The captured entry against its _eager body at two doy values (the
    Chou-Suarez entries, which take none, on two scenes): bitwise equal,
    one graph for the key, each kernel of the eager body counted once per
    replay; the replays and the eager body under
    set_sync_debug_mode("error")."""
    runs = [(0, DOY), (0, DOY + 0.001), (1, DOY + 0.25)]
    bounds = _sw_bounds(dev, (0, 1))
    assert bounds[0] is not None
    cases = {seed: _scheme_calls(dev, seed, bounds)[name] for seed in (0, 1)}
    entry = cases[0][0]
    before = len(entry.graphs)

    def args(seed, doy):
        _, _, a, kw, takes_doy = cases[seed]
        return (*a, doy) if takes_doy else a, kw
    a, kw = args(0, DOY)
    LAUNCHES.clear()
    entry.body(*a, **kw)
    torch.cuda.synchronize()
    eager_launches = dict(LAUNCHES)
    entry(*a, **kw)                                 # warm-up + capture
    assert len(entry.graphs) == before + 1
    for seed, doy in runs:
        a, kw = args(seed, doy)
        LAUNCHES.clear()
        got, want = _sync_free(lambda: entry(*a, **kw),
                               lambda: cases[seed][1](*a, **kw))
        assert dict(LAUNCHES) == {k: 2 * n for k, n in
                                  eager_launches.items()}
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, seed, doy, k)
    assert len(entry.graphs) == before + 1


@pytest.mark.parametrize("pair", ["chou/chou", "rrtmgp/rrtmgp", "native",
                                  "rrtmg/chou"])
def test_refresh_under_other_schemes_replays_bitwise_equal(dev, tmp_path,
                                                           pair):
    """radiation_refresh at 48 x 72 captured under Chou/Chou,
    RRTMGP/RRTMGP (the facade), the native engine and RRTMG SW + Chou LW:
    the replays at two doy values bitwise equal to
    radiation_refresh_eager under disable_capture(), the eager run's
    launches once per replay, no scheme entry recording a graph of its
    own; replay and eager body under set_sync_debug_mode("error")."""
    from chip_smoke import save_kdist_npz, synthetic_kdist
    schemes = {"chou/chou": dict(sw_scheme=Scheme.CHOU,
                                 lw_scheme=Scheme.CHOU),
               "rrtmgp/rrtmgp": dict(sw_scheme=Scheme.RRTMGP,
                                     lw_scheme=Scheme.RRTMGP),
               "rrtmg/chou": dict(sw_scheme=Scheme.RRTMG,
                                  lw_scheme=Scheme.CHOU)}
    if pair == "native":
        paths = [str(tmp_path / f"{b}.npz") for b in ("lw", "sw")]
        for p in paths:
            save_kdist_npz(synthetic_kdist(), p)
        cfg = RadiationConfig(sw_scheme=Scheme.RRTMGP,
                              lw_scheme=Scheme.RRTMGP,
                              rrtmgp_kdist_lw=paths[0],
                              rrtmgp_kdist_sw=paths[1],
                              outputs=frozenset({"olrb"}))
    else:
        cfg = RadiationConfig(**schemes[pair])
    # 48 columns: a key no other test captures
    inp = example_inputs(48, NLEV, device=dev)
    entries = (lwm.rrtmg_lw, swm.rrtmg_sw, chou_sw_mod.chou_sw,
               chou_lw_mod.chou_lw, gp.rrtmgp_sw, gp.rrtmgp_lw)
    graphs = [dict(e.graphs) for e in entries]

    def refresh(doy, eager=False):
        if eager:
            with disable_capture():
                return step.radiation_refresh_eager(inp, doy, 12.0,
                                                    config=cfg, ict=69,
                                                    icb=71)
        return step.radiation_refresh(inp, doy, 12.0, config=cfg, ict=69,
                                      icb=71)
    LAUNCHES.clear()
    refresh(DOY, eager=True)
    torch.cuda.synchronize()
    eager_launches = dict(LAUNCHES)
    before = len(step.radiation_refresh.graphs)
    refresh(DOY)                                    # warm-up + capture
    assert len(step.radiation_refresh.graphs) == before + 1
    assert [dict(e.graphs) for e in entries] == graphs
    for doy in (DOY, DOY + 0.001):
        LAUNCHES.clear()
        got, want = _sync_free(lambda: refresh(doy),
                               lambda: refresh(doy, eager=True))
        assert dict(LAUNCHES) == {k: 2 * n for k, n in
                                  eager_launches.items()}
        for a, b in zip(_step_tensors(got), _step_tensors(want)):
            assert torch.equal(a, b), (pair, doy)
    assert len(step.radiation_refresh.graphs) == before + 1


def test_rats_replays_bitwise_equal_eager(rats):
    """RATS's 8 solves through one captured rrtmg_lw graph: K1, K3 and K4
    counted 8 times each over the replays and K9 16 times (cloud and
    Planck rows of each solve), the states bitwise equal to
    the eager run's, and a second RATS refresh replayed and run eagerly
    under set_sync_debug_mode("error")."""
    inp, lw, kern, _, launches, _, eager = rats
    assert launches == dict(dict.fromkeys(("mcica_optics_lw", "taumol_lw",
                                           "rtrnmc"), len(RATS_GASES)),
                            lw_rows=2 * len(RATS_GASES))
    for f in kern._fields:
        assert torch.equal(getattr(kern, f), getattr(eager, f)), f
    keys = [k for k in lwm.rrtmg_lw.graphs if ("lw", lw) in k[0]]
    assert len(keys) == 1
    cfg = RadiationConfig()

    def eager_run():
        with disable_capture():
            return rats_refresh(inp, DOY + 0.5, cfg, 69, 71, lw=lw)
    LAUNCHES.clear()
    got, want = _sync_free(
        lambda: rats_refresh(inp, DOY + 0.5, cfg, 69, 71, lw=lw), eager_run)
    assert dict(LAUNCHES) == {k: 2 * n for k, n in launches.items()}
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert [k for k in lwm.rrtmg_lw.graphs if ("lw", lw) in k[0]] == keys


def test_step_capture_records_no_scheme_graph(dev):
    """The step refresh's capture runs rrtmg_sw and rrtmg_lw's bodies
    inside its own graph: a new step key adds no graph to either."""
    cfg = RadiationConfig()
    inp = example_inputs(40, NLEV, seed=3, device=dev)
    sw, lw = rad.reference_modules(dev)
    before = [dict(e.graphs) for e in (lwm.rrtmg_lw, swm.rrtmg_sw)]
    n = len(step.radiation_refresh.graphs)
    LAUNCHES.clear()
    step.radiation_refresh(inp, DOY, 12.0, config=cfg, ict=69, icb=71,
                           sw=sw, lw=lw)
    torch.cuda.synchronize()
    assert len(step.radiation_refresh.graphs) == n + 1
    assert dict(LAUNCHES) == step_launches(1)
    assert [dict(e.graphs) for e in (lwm.rrtmg_lw, swm.rrtmg_sw)] == before
