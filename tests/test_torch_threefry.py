"""The port's threefry stream and McICA seeds against jax.random and the
JAX oracle: exact."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.driver import radiation as jrad
from geosradiation_gridcomp_tpu.ops import mcica as jm
from geosradiation_gridcomp_tpu_torch.driver import radiation as trad
from geosradiation_gridcomp_tpu_torch.ops import mcica as tm
from geosradiation_gridcomp_tpu_torch.ops import threefry as tf
from geosradiation_gridcomp_tpu_torch.scene import example_inputs

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from __graft_entry__ import _example_inputs  # noqa: E402

torch.set_num_threads(1)


def _jkey(words):
    return np.asarray(jax.random.key_data(words), np.int64)


@pytest.mark.parametrize("data", [(0, 1, 2, 3), (123456789, 987654321, 5,
                                                  2147483000),
                                  (4294967295, 1, 77, 3000000000)])
def test_fold_in_split_uniform_exact(data):
    jk = jax.random.key(0)
    tk = tf.key(0, device="cpu")
    for d in data:
        jk = jax.random.fold_in(jk, jnp.uint32(d))
        tk = tf.fold_in(tk, torch.tensor(d, dtype=torch.int64))
    np.testing.assert_array_equal(tk.numpy(), _jkey(jk))
    jks = jax.random.split(jk, 4)
    tks = tf.split(tk, 4)
    np.testing.assert_array_equal(tks.numpy(), _jkey(jks))
    for i in range(4):
        ju = np.asarray(jax.random.uniform(jks[i], (140, 72), jnp.float32))
        tu = tf.uniform(tks[i], (140, 72)).numpy()
        assert ju.tobytes() == tu.tobytes()


def test_uniform_batched_keys_exact():
    """A batch of keys draws each key's own stream."""
    keys = [jax.random.fold_in(jax.random.key(0), i) for i in range(5)]
    tk = torch.as_tensor(np.stack([_jkey(k) for k in keys]))
    tu = tf.uniform(tk, (3, 7)).numpy()
    for i, k in enumerate(keys):
        ju = np.asarray(jax.random.uniform(k, (3, 7), jnp.float32))
        assert ju.tobytes() == tu[i].tobytes()


def test_scene_matches_reference_scene():
    ji = _example_inputs(16, 72, seed=3)
    ti = example_inputs(16, 72, seed=3, device="cpu")
    assert ti._fields == ji._fields
    for f in ji._fields:
        a, b = np.asarray(getattr(ji, f)), getattr(ti, f).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("seed_order", [(0, 1, 2, 3), (3, 2, 1, 0)])
def test_state_seeds_exact(seed_order):
    ji = _example_inputs(16, 72)
    ti = example_inputs(16, 72, device="cpu")
    jplay = jrad._common_derived(ji)[0]
    tplay = trad._common_derived(ti)[0]
    assert np.asarray(jplay).tobytes() == tplay.numpy().tobytes()
    js = jax.vmap(lambda p: jm.state_seed_ints(p, seed_order))(jplay)
    ts = tm.state_seed_ints(tplay, seed_order)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js, np.int64))
    jkeys = jax.vmap(lambda p: jax.random.split(
        jm.state_seed_key(p, seed_order), 4))(jplay)
    np.testing.assert_array_equal(
        tm.subcolumn_keys(tplay, seed_order).numpy(), _jkey(jkeys))
