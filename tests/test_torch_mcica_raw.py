"""Kernel K7's plain twin (the raw McICA draws) against the JAX CPU
oracle's own intermediates on the realistic scene (8 columns x 72 levels).

The oracle's per-column generator (geosradiation_gridcomp_tpu/ops/
mcica.py:228-241) is rebuilt here from its parts: state_seed_key,
jax.random.split / uniform and _correlate. The raw presence mask and the
forward-filled condensate cdf match it exactly, for the LW and SW seed
orders; the raw draws with the exact zcw table and the cwp_tiny threshold
reproduce generate_stochastic_clouds: cloud masks exact, water paths to
relmax 1e-6 (the oracle's one-hot table contraction rounds its lookup
differently by an ulp; 2e-7 measured).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.driver import radiation as jrad
from geosradiation_gridcomp_tpu.models.rrtmg import lw as jlw
from geosradiation_gridcomp_tpu.ops import mcica as jm
from geosradiation_gridcomp_tpu_torch.ops import mcica as tm
from geosradiation_gridcomp_tpu_torch.ops.mcica_cuda import (
    mcica_subcols_raw, mcica_subcols_raw_plain)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from __graft_entry__ import _example_inputs  # noqa: E402

torch.set_num_threads(1)

NCOL, NLEV, NSUB, DOY = 8, 72, 140, 172.0
ORDERS = [(0, 1, 2, 3), (3, 2, 1, 0)]


@pytest.fixture(scope="module")
def scene():
    inp = _example_inputs(NCOL, NLEV)
    play = jrad._common_derived(inp)[0]
    zm = jlw.mid_heights(play, inp.t, inp.ple[..., -1])
    ciwp, clwp = jrad._incloud_paths(inp)
    alpha, rcorr = jm.overlap_params(zm, inp.lats, DOY)
    return dict(inp=inp, play=play, zm=zm, ciwp=ciwp, clwp=clwp,
                alpha=alpha, rcorr=rcorr)


def t(x):
    return torch.as_tensor(np.array(x))


def oracle_raw(j, seed_order):
    """The oracle generator's presence test and condensate cdf, per
    column, [ncol, nsub, nlay]."""
    def column(play_c, cldf_c, alpha_c, rcorr_c):
        key = jm.state_seed_key(play_c, seed_order)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        shape = (NSUB, play_c.shape[0])
        cdf1 = jax.random.uniform(k1, shape, jnp.float32)
        cdf2 = jax.random.uniform(k2, shape, jnp.float32)
        cdf1 = jm._correlate(cdf1, cdf2 >= alpha_c[None, :])
        cdf2b = jax.random.uniform(k3, shape, jnp.float32)
        cdf3 = jax.random.uniform(k4, shape, jnp.float32)
        return (cdf1 >= 1.0 - cldf_c[None, :],
                jm._correlate(cdf3, cdf2b >= rcorr_c[None, :]))
    out = jax.vmap(column)(j["play"], j["inp"].fcld, j["alpha"], j["rcorr"])
    return tuple(np.asarray(x) for x in out)


def port_raw(j, seed_order):
    keys = tm.subcolumn_keys(t(j["play"]), seed_order)
    return mcica_subcols_raw(keys, t(j["alpha"]), t(j["rcorr"]),
                             t(j["inp"].fcld), nsub=NSUB)


@pytest.mark.parametrize("seed_order", ORDERS)
def test_raw_draws_equal_oracle_intermediates(scene, seed_order):
    cloudy, v3 = port_raw(scene, seed_order)
    assert cloudy.shape == v3.shape == (NCOL, NLEV, NSUB)
    assert cloudy.dtype == v3.dtype == torch.float32
    want_cloudy, want_v3 = oracle_raw(scene, seed_order)
    assert 0.005 < want_cloudy.mean() < 0.5
    np.testing.assert_array_equal(cloudy.transpose(1, 2).numpy(),
                                  want_cloudy.astype(np.float32))
    np.testing.assert_array_equal(v3.transpose(1, 2).numpy(), want_v3)


@pytest.mark.parametrize("seed_order", ORDERS)
def test_raw_draws_with_exact_zcw_reproduce_oracle(scene, seed_order):
    j = scene
    cloudy, v3 = port_raw(j, seed_order)
    sigcls = tm._sigma_class(t(j["inp"].fcld))
    zcw = tm.zcw_lookup_class(v3, sigcls[:, :, None].expand_as(v3),
                              torch.as_tensor(tm.zcw_class_columns(1)))
    cl = cloudy > 0
    paths = []
    for wp in (t(j["ciwp"]), t(j["clwp"])):
        s = torch.where(cl, wp[:, :, None] * zcw, torch.zeros(()))
        paths.append(torch.where(s <= 1.0e-20, torch.zeros(()), s))
    cldy = cl & ((paths[0] > 0.0) | (paths[1] > 0.0))
    want = jm.generate_stochastic_clouds(
        j["zm"], j["inp"].lats, DOY, j["play"], j["inp"].fcld, j["ciwp"],
        j["clwp"], 1.0e-20, nsubcol=NSUB, inhm=1, seed_order=seed_order)
    np.testing.assert_array_equal(cldy.transpose(1, 2).numpy(),
                                  np.asarray(want[0]))
    for got, w in zip(paths, want[1:]):
        w = np.asarray(w, np.float64)
        err = np.abs(got.transpose(1, 2).numpy() - w).max()
        assert err / np.abs(w).max() <= 1e-6


def test_wrapper_on_cpu_is_plain(scene):
    keys = tm.subcolumn_keys(t(scene["play"]))
    args = (keys, t(scene["alpha"]), t(scene["rcorr"]),
            t(scene["inp"].fcld))
    for x, y in zip(mcica_subcols_raw(*args, nsub=NSUB),
                    mcica_subcols_raw_plain(*args, nsub=NSUB, col_block=3)):
        assert torch.equal(x, y)
