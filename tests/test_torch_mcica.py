"""The port's McICA generator and kernel K1's plain twin against the JAX
CPU oracle on the realistic scene (16 columns x 72 levels).

Masks and clear counts are exact (the threefry stream is bit-identical,
K1's twin seeding it from play as K1 does);
water paths and optical depths agree to 1e-6 relmax (max|a-b| / max|b|,
tools/verify_tpu.py:33-36).
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
    cldprmc_lw as j_cldprmc
from geosradiation_gridcomp_tpu.ops import mcica as jm
from geosradiation_gridcomp_tpu_torch.models.rrtmg.cldprmc_lw import (
    band_abs_coeffs_lw, cldprmc_lw, lw_cloud_tables)
from geosradiation_gridcomp_tpu_torch.ops import mcica as tm
from geosradiation_gridcomp_tpu_torch.ops.mcica_cuda import (
    mcica_optics_lw, mcica_optics_lw_plain)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from __graft_entry__ import _example_inputs  # noqa: E402

torch.set_num_threads(1)

NCOL, NLEV, DOY = 16, 72, 172.0
MH, LM = 28, 47


def relmax(a, b, floor=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def scene():
    inp = _example_inputs(NCOL, NLEV)
    play = jrad._common_derived(inp)[0]
    zm = jlw.mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = jrad._incloud_paths(inp)
    j = dict(inp=inp, play=play, zm=zm, ciwp=ciwp, clwp=clwp)
    cldy, ciwp_s, clwp_s = jm.generate_stochastic_clouds(
        zm, inp.lats, DOY, play, inp.fcld, ciwp, clwp, 1.0e-20,
        nsubcol=140, inhm=1, seed_order=(0, 1, 2, 3))
    j["clouds"] = (np.asarray(cldy), np.asarray(ciwp_s), np.asarray(clwp_s))
    j["counts"] = np.asarray(jm.clear_counts_three_band(cldy, MH, LM))
    taucmc_gl, cloudy = j_cldprmc(cldy, ciwp_s, clwp_s, inp.ri, inp.rl)
    j["taucmc"] = np.asarray(jnp.swapaxes(taucmc_gl, -1, -2))
    j["cloudy"] = np.asarray(cloudy)
    tt = {k: t(j[k]) for k in ("play", "zm", "ciwp", "clwp")}
    tt.update(fcld=t(inp.fcld), lats=t(inp.lats), ri=t(inp.ri),
              rl=t(inp.rl))
    return j, tt


def test_scene_is_cloudy(scene):
    j, _ = scene
    cldy = j["clouds"][0]
    assert 0.005 < cldy.mean() < 0.5
    assert (j["counts"][:, 0] < 140).sum() >= NCOL // 2


def test_overlap_params(scene):
    j, tt = scene
    ja, jr = jm.overlap_params(j["zm"], j["inp"].lats, DOY)
    ta, tr = tm.overlap_params(tt["zm"], tt["lats"], DOY)
    assert relmax(ta, ja) <= 1e-6
    assert relmax(tr, jr) <= 1e-6


def test_sigma_class_exact(scene):
    j, tt = scene
    np.testing.assert_array_equal(tm._sigma_class(tt["fcld"]).numpy(),
                                  np.asarray(jm._sigma_class(j["inp"].fcld)))


@pytest.mark.parametrize("inhm", [1, 2])
def test_zcw_class_columns_equal_oracle_table(inhm):
    t2 = np.asarray(jm._zcw_class_table(inhm)).reshape(96, 32, 2)
    lo = t2[..., 0].reshape(3, 1024)[:, :1000]
    np.testing.assert_array_equal(tm.zcw_class_columns(inhm), lo)


def test_zcw_lookup_matches_oracle():
    rng = np.random.default_rng(1)
    cdf = rng.uniform(0.0, 1.0, (3, 500)).astype(np.float32)
    cls = np.repeat(np.arange(3, dtype=np.int32)[:, None], 500, axis=1)
    j = np.asarray(jm.zcw_lookup_class(jnp.asarray(cdf), jnp.asarray(cls), 1))
    tcols = torch.as_tensor(tm.zcw_class_columns(1))
    p = tm.zcw_lookup_class(t(cdf), t(cls), tcols).numpy()
    assert relmax(p, j) <= 1e-6


def test_generate_stochastic_clouds(scene):
    j, tt = scene
    cldy, ciwp_s, clwp_s = tm.generate_stochastic_clouds(
        tt["zm"], tt["lats"], DOY, tt["play"], tt["fcld"], tt["ciwp"],
        tt["clwp"], 1.0e-20, nsubcol=140, inhm=1, seed_order=(0, 1, 2, 3),
        col_block=5)
    np.testing.assert_array_equal(cldy.numpy(), j["clouds"][0])
    assert relmax(ciwp_s, j["clouds"][1]) <= 1e-6
    assert relmax(clwp_s, j["clouds"][2]) <= 1e-6


def test_clear_counts_exact(scene):
    j, _ = scene
    counts = tm.clear_counts_three_band(t(j["clouds"][0]), MH, LM)
    np.testing.assert_array_equal(counts.numpy(), j["counts"])


def test_cldprmc_lw(scene):
    j, tt = scene
    cldy, ciwp_s, clwp_s = (t(x) for x in j["clouds"])
    taucmc, cloudy = cldprmc_lw(cldy, ciwp_s, clwp_s, tt["ri"], tt["rl"],
                                lw_cloud_tables("cpu"))
    np.testing.assert_array_equal(cloudy.numpy(), j["cloudy"])
    assert relmax(taucmc.transpose(-1, -2), j["taucmc"]) <= 1e-6


def _k1_args(tt):
    alpha, rcorr = tm.overlap_params(tt["zm"], tt["lats"], DOY)
    absi, absl = band_abs_coeffs_lw(tt["ri"], tt["rl"], lw_cloud_tables("cpu"))
    return (tt["play"], alpha, rcorr, tt["fcld"],
            tt["ciwp"], tt["clwp"], tm._sigma_class(tt["fcld"]),
            absi.contiguous(), absl.contiguous(),
            torch.as_tensor(tm.zcw_class_columns(1)))


def test_k1_plain_matches_oracle_composition(scene):
    """generate + clear counts + cldprmc, as lw.py:136-144 composes them."""
    j, tt = scene
    taucmc, cloudy, counts = mcica_optics_lw_plain(
        *_k1_args(tt), cloud_mh=MH, cloud_lm=LM, inhm=1, col_block=6)
    np.testing.assert_array_equal(cloudy.numpy(), j["cloudy"])
    np.testing.assert_array_equal(counts.numpy(), j["counts"])
    assert (taucmc.numpy() > 0).tolist() == (j["taucmc"] > 0).tolist()
    assert relmax(taucmc, j["taucmc"]) <= 1e-6


def test_k1_wrapper_on_cpu_is_plain(scene):
    _, tt = scene
    args = _k1_args(tt)
    a = mcica_optics_lw(*args, cloud_mh=MH, cloud_lm=LM, inhm=1)
    b = mcica_optics_lw_plain(*args, cloud_mh=MH, cloud_lm=LM, inhm=1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
