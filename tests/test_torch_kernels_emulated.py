"""The CUDA sources of K1-K7 and P1-P3 run on the CPU against their plain
PyTorch twins.

g++ compiles geosradiation_gridcomp_tpu_torch/csrc/*.cu against a host
emulation of the CUDA subset they use (tests/cuda_emu.h: one std::thread
per CUDA thread, barriers for __syncthreads and warp shuffles), and each
wrapper's `launch(lib, ...)` drives the emulated kernel with CPU tensors.
This checks the kernels' logic here; only the card can check that nvcc
builds them and how fast they run (chip_smoke.py, tests/test_torch_cuda.py).

Tolerances: K1 and K2 masks and counts exact, K1 optics exact (it uses
the twin's rounding: __fmul_rn/__fadd_rn), K2 optics relmax <= 1e-6 for
every SW iceflag and condensate PDF (its delta scaling folded into per-band
coefficients reorders the twin's products by a few ulps); the subkeys K1
and K2 derive in their prologue (mcica_gen.cuh:column_subkeys) equal
ops.mcica.subcolumn_keys bit for bit for every seed order the port uses; K3
and K5 elementwise within 1e-6 relative and K4 relmax <= 1e-6 (g++
builds with -ffp-contract=off and the same operation order; libm's
expf/powf may differ from torch's by an ulp). K6 relmax <= 1e-5: an ulp
of expf is amplified through the 72-layer adding sweeps and the
resonance-factored reflectances, and both float32 paths lie up to 7e-6
from a float64 evaluation of the plain twin on this scene. K7, P1 and both P2
kernels exact; P3's full variant equal to K3 bit for bit, and every
variant elementwise within 1e-6 relative of its twin (K3's gate).
"""

import ctypes
import glob
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu_torch.driver import radiation as rad
from geosradiation_gridcomp_tpu_torch.kernels.build import CSRC
from geosradiation_gridcomp_tpu_torch.models.rrtmg import lw as lwm
from geosradiation_gridcomp_tpu_torch.models.rrtmg import rtrnmc_cuda
from geosradiation_gridcomp_tpu_torch.models.rrtmg import spcvmc_cuda
from geosradiation_gridcomp_tpu_torch.models.rrtmg import sw as swm
from geosradiation_gridcomp_tpu_torch.models.rrtmg import taumol_lw_cuda
from geosradiation_gridcomp_tpu_torch.models.rrtmg import taumol_sw_cuda
from geosradiation_gridcomp_tpu_torch.models.rrtmg.cldprmc_lw import \
    band_abs_coeffs_lw
from geosradiation_gridcomp_tpu_torch.ops.mcica_cuda import seed_order_bits
from geosradiation_gridcomp_tpu_torch.models.rrtmg.rtrnmc import rtrnmc
from geosradiation_gridcomp_tpu_torch.models.rrtmg.setcoef_lw import \
    setcoef_lw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.setcoef_sw import \
    setcoef_sw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.spcvmc import spcvmc_sw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw import (
    PARTS, VARIANTS, _cells, taumol_lw)
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_sw import taumol_sw
from geosradiation_gridcomp_tpu_torch.ops import (ffill_cuda, gather_cuda,
                                                  mcica, mcica_cuda)
from geosradiation_gridcomp_tpu_torch.scene import example_inputs

torch.set_num_threads(1)

NCOL, NLEV, DOY = 4, 72, 172.0
MH, LM = 30, 50
HERE = os.path.dirname(os.path.abspath(__file__))
# LW, SW and the reseeded orders of tools/verify.py's noise runs
SEED_ORDERS = ((0, 1, 2, 3), (3, 2, 1, 0), (1, 2, 3, 0), (2, 3, 0, 1),
               (3, 0, 1, 2))
# the generator's key prologue alone, run on the host for each column
KEYS_PROBE = r"""
#include "mcica_gen.cuh"
using namespace geosrad;
extern "C" void column_subkeys_probe(const float* play, uint32_t* keys,
                                     int ncol, int nlay, int seed_order) {
    for (int c = 0; c < ncol; ++c)
        for (int t = 0; t < 4; ++t)
            column_subkeys(play + static_cast<size_t>(c) * nlay, nlay,
                           seed_order, t, keys + static_cast<size_t>(c) * 8);
}
"""


def relmax(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-6))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    out = tmp_path_factory.mktemp("cuda_emu")
    for header in ("cuda_runtime.h", "cuda_pipeline_primitives.h"):
        (out / header).write_text(
            f'#include "{os.path.join(HERE, "cuda_emu.h")}"\n')
    for src in glob.glob(os.path.join(CSRC, "*.cu*")):
        text = open(src).read().replace(
            "extern __shared__ __align__(16) unsigned char dyn_smem[];",
            "unsigned char* dyn_smem = emu_dyn_smem;")
        text = re.sub(r"(\w+(?:<[\w, ]+>)?)<<<(.*?)>>>\(",
                      r"emu_launch(\1, \2)(", text, flags=re.S)
        (out / os.path.basename(src)).write_text(text)
    (out / "keys_probe.cu").write_text(KEYS_PROBE)
    so = out / "libemu.so"
    cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
           f"-I{out}", "-x", "c++", *sorted(str(p) for p in out.glob("*.cu")),
           "-o", str(so), "-lpthread"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def case():
    inp = example_inputs(NCOL, NLEV, seed=4, device="cpu")
    # three cloudy columns, with cloud on both sides of the super-layer
    # boundaries (MH, LM), and one column clear everywhere
    fcld = inp.fcld.clone()
    fcld[:3, 40:44] = torch.maximum(fcld[:3, 40:44], torch.tensor(0.6))
    for c, l in ((0, MH - 2), (1, MH - 1), (2, LM - 2), (0, LM - 1)):
        fcld[c, l] = 0.5
    fcld[3] = 0.0
    ql = torch.where(fcld > 0, torch.clamp(inp.ql, min=5e-5), inp.ql)
    inp = inp._replace(fcld=fcld, ql=ql)
    lw = lwm.RRTMGLW.from_reference_tables("cpu")
    play, h2o, o3 = rad._common_derived(inp)
    zm = lwm.mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = rad._incloud_paths(inp)
    alpha, rcorr = mcica.overlap_params(zm, inp.lats, DOY)
    absi, absl = band_abs_coeffs_lw(inp.ri, inp.rl, lw.cloud_tables)
    k1 = (play, alpha, rcorr, inp.fcld, ciwp, clwp,
          mcica._sigma_class(inp.fcld), absi.contiguous(), absl.contiguous())
    tlev = lwm.level_temperatures(play, inp.t, inp.ple * 0.01, inp.tsinst)
    emis = inp.emis[:, None].expand(NCOL, 16).contiguous()
    z = torch.zeros_like(inp.co2)
    coefs = setcoef_lw(play, inp.t, inp.ple * 0.01, tlev, inp.tsinst, emis,
                       h2o, o3, inp.co2, inp.ch4, inp.n2o,
                       torch.full_like(z, 0.2095), z + 1e-7, inp.cfc11,
                       inp.cfc12, inp.hcfc22, z + 1e-10, lw.planck_tables)
    return dict(lw=lw, k1=k1, keys=mcica.subcolumn_keys(play), emis=emis,
                coefs=coefs, inp=inp)


def _probe_keys(lib, play, seed_order):
    """The subkeys column_subkeys derives, as subcolumn_keys' int64
    words [ncol, 4, 2]."""
    play = play.contiguous()
    out = torch.zeros(play.shape[0] * 8, dtype=torch.int32)
    lib.column_subkeys_probe(ctypes.c_void_p(play.data_ptr()),
                             ctypes.c_void_p(out.data_ptr()), play.shape[0],
                             play.shape[1], seed_order_bits(seed_order))
    return (out.long() & 0xFFFFFFFF).reshape(-1, 4, 2)


@pytest.mark.parametrize("seed_order", SEED_ORDERS, ids=str)
def test_prologue_keys_equal_subcolumn_keys(lib, case, seed_order):
    """On the scene's columns and on columns whose lowest four layers are
    whole Pa (seed 1), a Pa value just below a whole number (seed near
    2^31), zero and pressures of every magnitude."""
    rng = np.random.default_rng(11)
    crafted = rng.uniform(1.0, 1000.0, (6, NLEV)).astype(np.float32)
    crafted[:, -4:] = np.array([
        [1000.0, 850.0, 0.01, 1013.25],
        [0.009999999, 0.0, 500.0, 999.99994],
        [np.nextafter(np.float32(1.0), np.float32(0.0)), 2.0, 3.5, 7.0],
        [0.5, 0.25, 0.125, 0.0625],
        [1045.7, 1e-3, 1e-5, 123.456],
        [999.9999, 1000.0001, 99.99999, 100.00001]], np.float32)
    play = torch.cat([case["k1"][0], torch.as_tensor(crafted)])
    ints = mcica.state_seed_ints(play, seed_order)
    assert int(ints.min()) == 1 and int(ints.max()) >= 2 ** 31 - 256
    assert torch.equal(_probe_keys(lib, play, seed_order),
                       mcica.subcolumn_keys(play, seed_order))


@pytest.mark.parametrize("inhm", [0, 1, 2])
def test_k1_emulated_equals_plain(lib, case, inhm):
    zcw = case["lw"].zcw_cols(inhm)
    a = mcica_cuda.launch(lib, *case["k1"], zcw, MH, LM, inhm, 1.0e-20)
    b = mcica_cuda.mcica_optics_lw_plain(*case["k1"], zcw, cloud_mh=MH,
                                         cloud_lm=LM, inhm=inhm)
    assert 0 < int(b[1].sum()) and int(b[2][3, 0]) == 140
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_k1_emulated_sw_seed_order(lib, case):
    """K1 seeded in another order draws another realization, still the
    twin's."""
    zcw = case["lw"].zcw_cols(1)
    a = mcica_cuda.launch(lib, *case["k1"], zcw, MH, LM, 1, 1.0e-20,
                          seed_order=swm.SEED_ORDER_SW)
    b = mcica_cuda.mcica_optics_lw_plain(*case["k1"], zcw, cloud_mh=MH,
                                         cloud_lm=LM,
                                         seed_order=swm.SEED_ORDER_SW)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], mcica_cuda.mcica_optics_lw_plain(
        *case["k1"], zcw, cloud_mh=MH, cloud_lm=LM)[0])


@pytest.mark.parametrize("with_taua", [False, True])
def test_k3_emulated_matches_plain(lib, case, with_taua):
    rng = np.random.default_rng(3)
    taua = (torch.as_tensor(rng.uniform(0, 0.02, (NCOL, NLEV, 16))
                            .astype(np.float32)) if with_taua else None)
    tabs = case["lw"].taumol_tables
    a = taumol_lw_cuda.launch(lib, case["coefs"], tabs, taua)
    b = taumol_lw(case["coefs"], tabs, taua)
    assert bool(case["coefs"].lower.any()) and not bool(
        case["coefs"].lower.all())
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-30)


def _cell_block(coefs, start, shape):
    """The fields of coefs at the flat cells start.. as an array of cells
    of the given shape (columns x layers, or a flat cell axis)."""
    n = int(np.prod(shape))
    flat = _cells(coefs, coefs.jp.shape, slice(start, start + n))
    return type(coefs)(*(x.reshape(shape + x.shape[1:])
                         if x.shape[:1] == (n,) else x for x in flat))


@pytest.mark.parametrize("shape", [(1,), (31,), (33,), (203,), (37, 3),
                                   (65, 2)], ids=str)
@pytest.mark.parametrize("with_taua", [False, True])
def test_k3_emulated_ragged_tiles(lib, case, shape, with_taua):
    """Cell arrays whose last tile of 32 columns is part full."""
    coefs = _cell_block(case["coefs"], 7, shape)
    rng = np.random.default_rng(len(shape))
    taua = (torch.as_tensor(rng.uniform(0, 0.02, shape + (16,))
                            .astype(np.float32)) if with_taua else None)
    tabs = case["lw"].taumol_tables
    a = taumol_lw_cuda.launch(lib, coefs, tabs, taua)
    b = taumol_lw(coefs, tabs, taua)
    for x, y in zip(a, b):
        assert x.shape == shape + (140,)
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-30)


def test_k4_emulated_matches_plain(lib, case):
    c = case["coefs"]
    tau, cloudy, _ = mcica_cuda.mcica_optics_lw_plain(
        *case["k1"], case["lw"].zcw_cols(1), cloud_mh=MH, cloud_lm=LM)
    tg, pf = taumol_lw(c, case["lw"].taumol_tables)
    args = (case["emis"], tg, pf, cloudy, tau, c.planklay, c.planklev,
            c.plankbnd, c.dplankbnd_dts, c.pwvcm)
    a = rtrnmc_cuda.launch(lib, *args)
    b = rtrnmc(*args)
    assert set(a) == set(b)
    for k in b:
        assert relmax(a[k], b[k]) <= 1e-6, k


@pytest.mark.parametrize("kind", ["clear", "one_cloudy_layer", "five_layers"])
def test_k4_emulated_divergence_and_depth(lib, case, kind):
    """K4 with every column clear (the clear-sky stream follows the
    all-sky one), with one cloudy layer in one column, half its g-points
    cloudy (the column diverges below it on the way down and everywhere on
    the way up), and on five layers, fewer than its ring holds."""
    c = case["coefs"]
    tau, cloudy, _ = mcica_cuda.mcica_optics_lw_plain(
        *case["k1"], case["lw"].zcw_cols(1), cloud_mh=MH, cloud_lm=LM)
    tg, pf = taumol_lw(c, case["lw"].taumol_tables)
    planklay, planklev = c.planklay, c.planklev
    if kind == "five_layers":
        # the bottom five: near the model top the optical depths are so
        # small that an ulp of expf in 1 - exp(-tau) reaches 1e-6 of the
        # fluxes there
        tg, pf, tau, cloudy, planklay = (
            x[:, -5:].contiguous() for x in (tg, pf, tau, cloudy, planklay))
        planklev = planklev[:, -6:].contiguous()
    else:
        cloudy = torch.zeros_like(cloudy)
        tau = torch.zeros_like(tau)
        if kind == "one_cloudy_layer":
            rng = np.random.default_rng(9)
            cloudy[1, 37] = True
            tau[1, 37, ::2] = torch.as_tensor(
                rng.uniform(0.1, 3.0, 70).astype(np.float32))
    args = (case["emis"], tg, pf, cloudy, tau, planklay, planklev,
            c.plankbnd, c.dplankbnd_dts, c.pwvcm)
    a = rtrnmc_cuda.launch(lib, *args)
    b = rtrnmc(*args)
    for k in b:
        assert relmax(a[k], b[k]) <= 1e-6, k
    if kind == "clear":
        for clear, full in (("uflxc", "uflx"), ("dflxc", "dflx"),
                            ("duflxc_dts", "duflx_dts")):
            assert torch.equal(a[clear], a[full])
    elif kind == "one_cloudy_layer":
        assert torch.equal(a["dflxc"][1, :38], a["dflx"][1, :38])
        assert not torch.equal(a["uflxc"][1], a["uflx"][1])
        assert torch.equal(a["uflxc"][0], a["uflx"][0])


@pytest.fixture(scope="module")
def sw_case(case):
    """The SW kernels' inputs on the same scene: K2's (with liquid radii
    below 2.5 um in cloudy cells of the first three columns, where the
    liquid ssa overshoot clamp engages), setcoef_sw, and K6's optics from
    the plain twins."""
    inp = case["inp"]
    sw = swm.RRTMGSW.from_reference_tables("cpu")
    play, h2o, o3 = rad._common_derived(inp)
    zm = lwm.mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = rad._incloud_paths(inp)
    alpha, rcorr = mcica.overlap_params(zm, inp.lats, DOY)
    rel = inp.rl.clone()
    rel[:3, 40:44] = torch.tensor([1.1, 1.35, 1.6, 2.3])
    # below 2.5 um the interpolation extrapolates from rows 1-2 (fint < 0)
    ssal = sw.cloud_tables["ssaliq1"]
    fint = rel[:3, 40:44, None] - 2.5
    assert bool((ssal[0] + fint * (ssal[1] - ssal[0]) > 1.0).any())
    k2 = (play, alpha, rcorr, inp.fcld, ciwp, clwp,
          mcica._sigma_class(inp.fcld), inp.ri, rel)
    coefs = setcoef_sw(play, inp.t, inp.ple * 0.01, h2o, o3, inp.co2,
                       inp.ch4, torch.full_like(play, 0.2095),
                       sw.reference_tables)
    return dict(sw=sw, k2=k2, coefs=coefs)


def _k2(sw_case, iceflag, inhm, ncol=NCOL):
    """K2's arguments and the twin's keywords."""
    sw = sw_case["sw"]
    args = (*(x[:ncol] for x in sw_case["k2"]), sw.cloud_pack(iceflag),
            sw.zcw_cols(inhm))
    return args, dict(cloud_mh=MH, cloud_lm=LM, inhm=inhm,
                      seed_order=swm.SEED_ORDER_SW)


@pytest.mark.parametrize("inhm", [0, 1, 2])
def test_k2_emulated_matches_plain(lib, sw_case, inhm):
    _k2_emulated_matches_plain(lib, sw_case, 3, inhm)


@pytest.mark.parametrize("iceflag", [1, 2])
@pytest.mark.parametrize("inhm", [0, 1, 2])
def test_k2_emulated_other_iceflags(lib, sw_case, inhm, iceflag):
    _k2_emulated_matches_plain(lib, sw_case, iceflag, inhm)


def _k2_emulated_matches_plain(lib, sw_case, iceflag, inhm):
    args, kw = _k2(sw_case, iceflag, inhm)
    a = mcica_cuda.launch_sw(lib, *args, MH, LM, inhm, 1.0e-20,
                             swm.SEED_ORDER_SW)
    b = mcica_cuda.mcica_optics_sw_plain(*args, **kw)
    assert 0 < int(b[3].sum()) and int(b[4][3, 0]) == 112
    assert torch.equal(a[3], b[3]) and torch.equal(a[4], b[4])
    for x, y in zip(a[:3], b[:3]):
        assert relmax(x, y) <= 1e-6


@pytest.mark.parametrize("ncol", [1, 3])
def test_k2_emulated_part_full_block(lib, sw_case, ncol):
    """A column count that leaves the last block of two columns half
    empty."""
    args, kw = _k2(sw_case, 3, 1, ncol)
    a = mcica_cuda.launch_sw(lib, *args, MH, LM, 1, 1.0e-20,
                             swm.SEED_ORDER_SW)
    b = mcica_cuda.mcica_optics_sw_plain(*args, **kw)
    assert a[0].shape == (ncol, NLEV, 112)
    assert torch.equal(a[3], b[3]) and torch.equal(a[4], b[4])
    for x, y in zip(a[:3], b[:3]):
        assert relmax(x, y) <= 1e-6


def test_k5_emulated_matches_plain(lib, sw_case):
    c = sw_case["coefs"]
    assert bool(c.lower.any()) and not bool(c.lower.all())
    tabs = sw_case["sw"].taumol_tables
    a = taumol_sw_cuda.launch(lib, c, tabs)
    b = taumol_sw(c, tabs)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("shape", [(1,), (31,), (33,), (203,), (37, 3),
                                   (65, 2)], ids=str)
def test_k5_emulated_ragged_tiles(lib, sw_case, shape):
    """Cell arrays whose last tile of 32 columns is part full."""
    coefs = _cell_block(sw_case["coefs"], 7, shape)
    tabs = sw_case["sw"].taumol_tables
    a = taumol_sw_cuda.launch(lib, coefs, tabs)
    b = taumol_sw(coefs, tabs)
    for x, y in zip(a, b):
        assert x.shape == shape + (112,)
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-30)


def _k6_args(sw_case, aerosol):
    args, kw = _k2(sw_case, 3, 1)
    tau, ssa, asm, cldy, _ = mcica_cuda.mcica_optics_sw_plain(*args, **kw)
    tg, tr = taumol_sw(sw_case["coefs"], sw_case["sw"].taumol_tables)
    rng = np.random.default_rng(6)
    f = lambda lo, hi, shape: torch.as_tensor(
        rng.uniform(lo, hi, shape).astype(np.float32))
    aero = ((f(0.0, 0.1, (NCOL, NLEV, 14)), f(0.8, 1.0, (NCOL, NLEV, 14)),
             f(0.5, 0.8, (NCOL, NLEV, 14))) if aerosol else (None,) * 3)
    return (tg, tr, f(0.1, 20.0, (NCOL, 112)),
            torch.tensor([0.7, 0.3, 1e-5, 0.95]), f(0.05, 0.3, (NCOL, 14)),
            f(0.05, 0.3, (NCOL, 14)), cldy, tau, ssa, asm, *aero)


@pytest.mark.parametrize("aerosol,ncld", [(False, None), (True, 2)])
def test_k6_emulated_matches_plain(lib, sw_case, aerosol, ncld):
    args = _k6_args(sw_case, aerosol)
    a = spcvmc_cuda.launch(lib, *args, adjflux=1.02, ncld=ncld)
    b = spcvmc_sw(None, *args, adjflux=1.02, ncld=ncld)
    assert set(a) == set(b)
    for k in b:
        assert relmax(a[k], b[k]) <= 1e-5, k


@pytest.mark.parametrize("ncld", [0, 2, NCOL])
@pytest.mark.parametrize("aerosol", [False, True])
def test_k6_emulated_ncld(lib, sw_case, aerosol, ncld):
    """K6 with no, some and every column cloudy: within 1e-5 of the twin,
    and a second run equal bit for bit."""
    args = _k6_args(sw_case, aerosol)
    b = spcvmc_sw(None, *args, adjflux=1.02, ncld=ncld)
    a = spcvmc_cuda.launch(lib, *args, adjflux=1.02, ncld=ncld)
    again = spcvmc_cuda.launch(lib, *args, adjflux=1.02, ncld=ncld)
    assert all(torch.equal(again[k], a[k]) for k in a)
    for k in b:
        assert relmax(a[k], b[k]) <= 1e-5, k
    if ncld == 0:
        for clear, full in (("bbcu", "bbfu"), ("bbcd", "bbfd"),
                            ("nicd", "nifd")):
            assert torch.equal(a[clear], a[full])


def test_k7_emulated_equals_plain(lib, case):
    keys, (alpha, rcorr, cldf) = case["keys"], case["k1"][1:4]
    a = mcica_cuda.launch_raw(lib, keys, alpha, rcorr, cldf, 140)
    b = mcica_cuda.mcica_subcols_raw_plain(keys, alpha, rcorr, cldf, nsub=140)
    assert 0 < int(b[0].sum()) and float(b[1].std()) > 0.1
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_p1_emulated_equals_plain(lib):
    rng = np.random.default_rng(7)
    v = torch.as_tensor(rng.random((3, 9, 140)).astype(np.float32))
    keep = torch.as_tensor((rng.random((3, 9, 140)) > 0.6).astype(np.float32))
    assert torch.equal(ffill_cuda.launch(lib, v, keep),
                       ffill_cuda.ffill_plain(v, keep))


def _rows_case(name, seed=8):
    """gather_rows' inputs for a case of gather_cuda.ROWS_CASES."""
    n, rows, ng, lo, hi, off = gather_cuda.ROWS_CASES[name]
    rng = np.random.default_rng(seed)
    flat = torch.as_tensor(rng.standard_normal(rows * ng + off)
                           .astype(np.float32))
    tab = flat[off:].view(rows, ng)
    idx = torch.as_tensor(rng.integers(lo, hi, n).astype(np.int32))
    return idx, tab


@pytest.mark.parametrize("kind", ["rows", "lanes"] + [
    f"rows_{c}" for c in gather_cuda.ROWS_CASES if c != "tool"])
def test_p2_emulated_equals_plain(lib, kind):
    """gather_lanes, and gather_rows in every case of its contract
    (ROWS_CASES; "rows" is the tool's), each through its template
    instance: float4, float2 (ng 14) or float (ng 5, a table off 16 B)."""
    if kind == "lanes":
        idx, tab = _rows_case("tool")
        tabt = torch.nn.functional.pad(tab.T, (0, 640 - 585)).contiguous()
        a = gather_cuda.launch_lanes(lib, idx.reshape(64, 128), tabt)
        b = gather_cuda.gather_lanes_plain(idx.reshape(64, 128), tabt)
        assert torch.equal(a, b)
        return
    name = "tool" if kind == "rows" else kind[len("rows_"):]
    idx, tab = _rows_case(name)
    a = gather_cuda.launch_rows(lib, idx, tab)
    b = gather_cuda.gather_rows_plain(idx, tab)
    assert a.shape == b.shape and torch.equal(a, b)
    assert gather_cuda.rows_vec(tab, a, lib) == {
        "ng14": 2, "ng5": 1, "unaligned": 1}.get(name, 4)
    if name == "clamped":
        assert int(idx.min()) < 0 and int(idx.max()) >= tab.shape[0]


def test_p3_full_emulated_equals_k3(lib, case):
    tabs = case["lw"].taumol_tables
    a = taumol_lw_cuda.launch_bisect(lib, case["coefs"], tabs, PARTS)
    b = taumol_lw_cuda.launch(lib, case["coefs"], tabs)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("shape", [(31,), (203,), (37, 3)], ids=str)
def test_p3_full_emulated_equals_k3_ragged(lib, case, shape):
    coefs = _cell_block(case["coefs"], 40, shape)
    tabs = case["lw"].taumol_tables
    a = taumol_lw_cuda.launch_bisect(lib, coefs, tabs, PARTS)
    b = taumol_lw_cuda.launch(lib, coefs, tabs)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_p3_emulated_matches_plain(lib, case, variant):
    parts = VARIANTS[variant]
    tabs = case["lw"].taumol_tables
    a = taumol_lw_cuda.launch_bisect(lib, case["coefs"], tabs, parts)
    b = taumol_lw(case["coefs"], tabs, parts=parts)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-30)
    if "planck" not in parts:
        assert not bool(a[1].any())
