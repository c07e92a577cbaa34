"""The CUDA sources of K1-K6 run on the CPU against their plain PyTorch
twins.

g++ compiles geosradiation_gridcomp_tpu_torch/csrc/*.cu against a host
emulation of the CUDA subset they use (tests/cuda_emu.h: one std::thread
per CUDA thread, barriers for __syncthreads and warp shuffles), and each
wrapper's `launch(lib, ...)` drives the emulated kernel with CPU tensors.
This checks the kernels' logic here; only the card can check that nvcc
builds them and how fast they run (chip_smoke.py, tests/test_torch_cuda.py).

Tolerances: K1 and K2 masks and counts exact, K1 optics exact (it uses
the twin's rounding: __fmul_rn/__fadd_rn), K2 optics relmax <= 1e-6; K3
and K5 elementwise within 1e-6 relative and K4 relmax <= 1e-6 (g++
builds with -ffp-contract=off and the same operation order; libm's
expf/powf may differ from torch's by an ulp). K6 relmax <= 1e-5: an ulp
of expf is amplified through the 72-layer adding sweeps and the
resonance-factored reflectances, and both float32 paths lie up to 7e-6
from a float64 evaluation of the plain twin on this scene.
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
from geosradiation_gridcomp_tpu_torch.models.rrtmg.cldprmc_sw import \
    band_optics_coeffs_sw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.rtrnmc import rtrnmc
from geosradiation_gridcomp_tpu_torch.models.rrtmg.setcoef_lw import \
    setcoef_lw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.setcoef_sw import \
    setcoef_sw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.spcvmc import spcvmc_sw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw import taumol_lw
from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_sw import taumol_sw
from geosradiation_gridcomp_tpu_torch.ops import mcica, mcica_cuda
from geosradiation_gridcomp_tpu_torch.scene import example_inputs

torch.set_num_threads(1)

NCOL, NLEV, DOY = 4, 72, 172.0
MH, LM = 30, 50
HERE = os.path.dirname(os.path.abspath(__file__))


def relmax(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-6))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    out = tmp_path_factory.mktemp("cuda_emu")
    (out / "cuda_runtime.h").write_text(
        f'#include "{os.path.join(HERE, "cuda_emu.h")}"\n')
    for src in glob.glob(os.path.join(CSRC, "*.cu*")):
        text = open(src).read().replace(
            "extern __shared__ __align__(16) unsigned char dyn_smem[];",
            "unsigned char* dyn_smem = emu_dyn_smem;")
        text = re.sub(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2)(", text,
                      flags=re.S)
        (out / os.path.basename(src)).write_text(text)
    so = out / "libemu.so"
    cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
           f"-I{out}", "-x", "c++", *sorted(str(p) for p in out.glob("*.cu")),
           "-o", str(so), "-lpthread"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def case():
    inp = example_inputs(NCOL, NLEV, seed=4)
    # three cloudy columns, with cloud on both sides of the super-layer
    # boundaries (MH, LM), and one column clear everywhere
    fcld = inp.fcld.clone()
    fcld[:3, 40:44] = torch.maximum(fcld[:3, 40:44], torch.tensor(0.6))
    for c, l in ((0, MH - 2), (1, MH - 1), (2, LM - 2), (0, LM - 1)):
        fcld[c, l] = 0.5
    fcld[3] = 0.0
    ql = torch.where(fcld > 0, torch.clamp(inp.ql, min=5e-5), inp.ql)
    inp = inp._replace(fcld=fcld, ql=ql)
    lw = lwm.RRTMGLW.from_reference_tables()
    play, h2o, o3 = rad._common_derived(inp)
    zm = lwm.mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = rad._incloud_paths(inp)
    alpha, rcorr = mcica.overlap_params(zm, inp.lats, DOY)
    absi, absl = band_abs_coeffs_lw(inp.ri, inp.rl, lw.cloud_tables)
    k1 = (mcica.subcolumn_keys(play), alpha, rcorr, inp.fcld, ciwp, clwp,
          mcica._sigma_class(inp.fcld), absi.contiguous(), absl.contiguous())
    tlev = lwm.level_temperatures(play, inp.t, inp.ple * 0.01, inp.tsinst)
    emis = inp.emis[:, None].expand(NCOL, 16).contiguous()
    z = torch.zeros_like(inp.co2)
    coefs = setcoef_lw(play, inp.t, inp.ple * 0.01, tlev, inp.tsinst, emis,
                       h2o, o3, inp.co2, inp.ch4, inp.n2o,
                       torch.full_like(z, 0.2095), z + 1e-7, inp.cfc11,
                       inp.cfc12, inp.hcfc22, z + 1e-10, lw.planck_tables)
    return dict(lw=lw, k1=k1, emis=emis, coefs=coefs, inp=inp)


@pytest.mark.parametrize("inhm", [0, 1, 2])
def test_k1_emulated_equals_plain(lib, case, inhm):
    zcw = case["lw"].zcw_cols(inhm)
    a = mcica_cuda.launch(lib, *case["k1"], zcw, MH, LM, inhm, 1.0e-20)
    b = mcica_cuda.mcica_optics_lw_plain(*case["k1"], zcw, cloud_mh=MH,
                                         cloud_lm=LM, inhm=inhm)
    assert 0 < int(b[1].sum()) and int(b[2][3, 0]) == 140
    for x, y in zip(a, b):
        assert torch.equal(x, y)


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


@pytest.fixture(scope="module")
def sw_case(case):
    """The SW kernels' inputs on the same scene: K2's with the SW seed
    order, setcoef_sw, and K6's optics from the plain twins."""
    inp = case["inp"]
    sw = swm.RRTMGSW.from_reference_tables()
    play, h2o, o3 = rad._common_derived(inp)
    zm = lwm.mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = rad._incloud_paths(inp)
    alpha, rcorr = mcica.overlap_params(zm, inp.lats, DOY)
    coeffs = torch.stack(band_optics_coeffs_sw(inp.ri, inp.rl,
                                               sw.cloud_tables))
    k2 = (mcica.subcolumn_keys(play, swm.SEED_ORDER_SW), alpha, rcorr,
          inp.fcld, ciwp, clwp, mcica._sigma_class(inp.fcld), coeffs)
    coefs = setcoef_sw(play, inp.t, inp.ple * 0.01, h2o, o3, inp.co2,
                       inp.ch4, torch.full_like(play, 0.2095),
                       sw.reference_tables)
    return dict(sw=sw, k2=k2, coefs=coefs)


@pytest.mark.parametrize("inhm", [0, 1, 2])
def test_k2_emulated_matches_plain(lib, sw_case, inhm):
    zcw = sw_case["sw"].zcw_cols(inhm)
    kw = dict(cloud_mh=MH, cloud_lm=LM, inhm=inhm)
    a = mcica_cuda.launch_sw(lib, *sw_case["k2"], zcw, MH, LM, inhm, 1.0e-20)
    b = mcica_cuda.mcica_optics_sw_plain(*sw_case["k2"], zcw, **kw)
    assert 0 < int(b[3].sum()) and int(b[4][3, 0]) == 112
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


@pytest.mark.parametrize("aerosol,ncld", [(False, None), (True, 2)])
def test_k6_emulated_matches_plain(lib, sw_case, aerosol, ncld):
    tau, ssa, asm, cldy, _ = mcica_cuda.mcica_optics_sw_plain(
        *sw_case["k2"], sw_case["sw"].zcw_cols(1), cloud_mh=MH, cloud_lm=LM)
    tg, tr = taumol_sw(sw_case["coefs"], sw_case["sw"].taumol_tables)
    rng = np.random.default_rng(6)
    f = lambda lo, hi, shape: torch.as_tensor(
        rng.uniform(lo, hi, shape).astype(np.float32))
    aero = ((f(0.0, 0.1, (NCOL, NLEV, 14)), f(0.8, 1.0, (NCOL, NLEV, 14)),
             f(0.5, 0.8, (NCOL, NLEV, 14))) if aerosol else (None,) * 3)
    args = (tg, tr, f(0.1, 20.0, (NCOL, 112)),
            torch.tensor([0.7, 0.3, 1e-5, 0.95]), f(0.05, 0.3, (NCOL, 14)),
            f(0.05, 0.3, (NCOL, 14)), cldy, tau, ssa, asm, *aero)
    a = spcvmc_cuda.launch(lib, *args, adjflux=1.02, ncld=ncld)
    b = spcvmc_sw(None, *args, adjflux=1.02, ncld=ncld)
    assert set(a) == set(b)
    for k in b:
        assert relmax(a[k], b[k]) <= 1e-5, k
