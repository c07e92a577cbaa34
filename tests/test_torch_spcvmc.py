"""The port's RRTMG-SW two-stream solver (spcvmc_sw, the plain twin of
kernel K6) against the JAX CPU oracle on the realistic scene (8 columns x
72 levels): the oracle's own gas and cloud optics in, with and without
aerosol and with the ncld split; every output <= 5e-5 relmax
(max|a-b| / max|b|; the reference's PIFM solver sits ~6e-6 from its
literal expressions, ROADMAP Queue 3, so no SW gate goes below ~1e-5).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.driver import radiation as jrad
from geosradiation_gridcomp_tpu.models.rrtmg import lw as jlw
from geosradiation_gridcomp_tpu.models.rrtmg.cldprmc_sw import cldprmc_sw
from geosradiation_gridcomp_tpu.models.rrtmg.nrlssi2 import \
    solar_source_weights
from geosradiation_gridcomp_tpu.models.rrtmg.setcoef_sw import setcoef_sw
from geosradiation_gridcomp_tpu.models.rrtmg.spcvmc import (
    reftra_sw as j_reftra, spcvmc_sw as j_spcvmc)
from geosradiation_gridcomp_tpu.models.rrtmg.taumol_sw import taumol_sw
from geosradiation_gridcomp_tpu.ops import mcica as jm
from geosradiation_gridcomp_tpu_torch.models.rrtmg.spcvmc import (
    BAND_KEYS, LEVEL_KEYS, SFC_KEYS, reftra_sw, spcvmc_sw)
from geosradiation_gridcomp_tpu_torch.models.rrtmg.spcvmc_cuda import \
    spcvmc_fast

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from __graft_entry__ import _example_inputs  # noqa: E402

torch.set_num_threads(1)

NCOL, NLEV, DOY = 8, 72, 172.0


def relmax(a, b, floor=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


@pytest.fixture(scope="module")
def args():
    """spcvmc_sw's inputs as numpy: the oracle's gas optics and McICA
    cloud optics on the scene, cosines from night to overhead, random
    albedos and aerosol optics."""
    inp = _example_inputs(NCOL, NLEV)
    play, h2o, o3 = jrad._common_derived(inp)
    coefs = setcoef_sw(play, inp.t, inp.ple * 0.01, h2o, o3, inp.co2,
                       inp.ch4, jnp.full_like(play, 0.2095))
    svw = solar_source_weights(-1, 1361.0, None, None, None)
    taug, taur, sfluxzen = taumol_sw(coefs, svw)
    zm = jlw.mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = jrad._incloud_paths(inp)
    cldy, ciwp_s, clwp_s = jm.generate_stochastic_clouds(
        zm, inp.lats, DOY, play, inp.fcld, ciwp, clwp, 1.0e-20,
        nsubcol=112, inhm=1, seed_order=(3, 2, 1, 0))
    swap = lambda x: np.ascontiguousarray(np.swapaxes(np.array(x), -1, -2))
    tc, sc, ac, _ = (swap(x) for x in cldprmc_sw(cldy, ciwp_s, clwp_s,
                                                  inp.ri, inp.rl))
    rng = np.random.default_rng(3)
    u = lambda lo, hi, shape: rng.uniform(lo, hi, shape).astype(np.float32)
    mu0 = np.array([0.9, 0.02, -0.3, 0.5, 1e-5, 0.7, 0.35, 0.999],
                   np.float32)
    aero = (u(0.0, 0.1, (NCOL, NLEV, 14)), u(0.8, 1.0, (NCOL, NLEV, 14)),
            u(0.5, 0.8, (NCOL, NLEV, 14)))
    return dict(coefs=coefs, base=(np.array(taug), np.array(taur),
                                   np.array(sfluxzen), mu0,
                                   u(0.05, 0.3, (NCOL, 14)),
                                   u(0.05, 0.3, (NCOL, 14)), swap(cldy),
                                   tc, sc, ac),
                aero=aero)


@pytest.mark.parametrize("aerosol,ncld", [(False, None), (True, None),
                                          (False, 5)])
def test_spcvmc_sw(args, aerosol, ncld):
    aero = args["aero"] if aerosol else (None,) * 3
    ref = j_spcvmc(args["coefs"], *(jnp.asarray(x) for x in args["base"]),
                   *(None if x is None else jnp.asarray(x) for x in aero),
                   adjflux=1.02, ncld=ncld)
    out = spcvmc_sw(None, *(torch.as_tensor(x) for x in args["base"]),
                    *(None if x is None else torch.as_tensor(x)
                      for x in aero), adjflux=1.02, ncld=ncld)
    assert set(out) == set(ref) == set(LEVEL_KEYS + SFC_KEYS + BAND_KEYS)
    for k in ref:
        assert tuple(out[k].shape) == ref[k].shape, k
        assert relmax(out[k], ref[k]) <= 5e-5, k


def test_ncld_aliases_clear_sky(args):
    out = spcvmc_sw(None, *(torch.as_tensor(x) for x in args["base"]),
                    ncld=5)
    for a, c in (("bbfu", "bbcu"), ("bbfd", "bbcd"), ("uvfd", "uvcd")):
        assert torch.equal(out[a][5:], out[c][5:])
        assert not torch.equal(out[a][:5], out[c][:5])


def test_reftra_sw_branches():
    """Random layers around the conservative-scattering threshold and
    the zrk*mu0 = 1 resonance: the branch choice and R/T agree."""
    rng = np.random.default_rng(8)
    n = 4096
    tau = rng.exponential(2.0, (1, n)).astype(np.float32)
    g = rng.uniform(0.0, 0.9, (1, n)).astype(np.float32)
    womz = np.where(rng.uniform(size=(1, n)) < 0.5,
                    rng.uniform(0.0, 1e-6, (1, n)),
                    rng.uniform(0.0, 0.5, (1, n))).astype(np.float32)
    w = (1.0 - womz).astype(np.float32)
    mu0 = np.array([0.6], np.float32)
    a = reftra_sw(*(torch.as_tensor(x) for x in (tau, w, g, mu0, womz)))
    b = j_reftra(*(jnp.asarray(x) for x in (tau, w, g, mu0, womz)))
    for x, y in zip(a, b):
        assert relmax(x, y) <= 5e-5


def test_spcvmc_wrapper_on_cpu_is_plain(args):
    base = [torch.as_tensor(x) for x in args["base"]]
    aero = [torch.as_tensor(x) for x in args["aero"]]
    a = spcvmc_fast(None, *base, *aero, ncld=6)
    b = spcvmc_sw(None, *base, *aero, ncld=6)
    for k in b:
        assert torch.equal(a[k], b[k])
