"""The port's column sharding and staged input feed (parallel/), on the
CPU, against the reference's semantics (tests/test_parallel.py) and the
unsharded refresh.

The four tests of tests/test_parallel.py on the port (a mesh of CPU
devices stands for the cards); pad_columns equal to the oracle's; the
refresh through shard_columns + run_sharded, and over two processes
(torch.distributed with gloo, each rank refreshing its
process_local_slice of a 16 x 72 scene, the slices gathered), against the
single-process refresh: every SolarState and IrradState field within
5e-5 relmax (the LW end-to-end gate, tools/verify_tpu.py:243). Measured:
the two 8-column shards and the two gloo ranks bitwise equal (relmax 0);
the padded scene's two 9-column shards 1.2e-7 (torch's CPU loops take
another vector/scalar split at 9 columns than at 16).
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosradiation_gridcomp_tpu.parallel.sharding import \
    pad_columns as j_pad_columns
from geosradiation_gridcomp_tpu_torch.config import RadiationConfig
from geosradiation_gridcomp_tpu_torch.driver.radiation import AtmosInputs
from geosradiation_gridcomp_tpu_torch.driver.step import radiation_refresh
from geosradiation_gridcomp_tpu_torch.parallel.distributed import (
    StagedFeed, initialize_distributed, process_local_slice,
    run_steps_overlapped)
from geosradiation_gridcomp_tpu_torch.parallel.sharding import (
    column_mesh, pad_columns, run_sharded, shard_columns, tree_leaves)
from geosradiation_gridcomp_tpu_torch.scene import example_inputs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
NLEV, DOY, UTC = 72, 172.0, 12.0


def relmax(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-6))


def test_initialize_single_process_noop():
    rank, n = initialize_distributed()
    assert rank == 0 and n == 1


def test_process_local_slice_covers():
    assert process_local_slice(1000) == (0, 1000)   # single-process run


def test_staged_feed_roundtrip():
    mesh = column_mesh([CPU, CPU])
    feed = StagedFeed(mesh)
    x = {"a": np.arange(16.0, dtype=np.float32).reshape(16, 1)}
    feed.put(x)
    shards = feed.get()
    # split over the mesh's leading axis, one shard per device
    assert len(shards) == len(mesh)
    assert [s["a"].shape[0] for s in shards] == [8, 8]
    np.testing.assert_array_equal(
        torch.cat([s["a"] for s in shards]).numpy(), x["a"])
    x["a"][:] = -1.0                  # the feed staged a copy
    assert float(shards[0]["a"][0, 0]) == 0.0


def test_run_steps_overlapped_order():
    mesh = column_mesh([CPU, CPU])
    batches = [{"a": np.full((8, 1), float(i), np.float32)}
               for i in range(5)]
    outs = run_steps_overlapped(lambda b: b["a"].sum(dim=1), batches, mesh)
    np.testing.assert_allclose([float(o.sum()) for o in outs],
                               [i * 8.0 for i in range(5)])
    assert run_steps_overlapped(lambda b: b, [], mesh) == []


def test_get_before_put_raises():
    with pytest.raises(RuntimeError, match="before put"):
        StagedFeed(device="cpu").get()


def test_mesh_and_feed_need_a_card_unless_given_the_cpu():
    """column_mesh() and StagedFeed() default to the card(s): on a torch
    without CUDA they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in column_mesh())
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        column_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StagedFeed()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_steps_overlapped(lambda b: b, [np.zeros(2)])


@pytest.mark.parametrize("ncol,multiple", [(10, 4), (8, 4), (7, 8)])
def test_pad_columns_matches_oracle(ncol, multiple):
    rng = np.random.default_rng(ncol)
    tree = {"x": rng.random((ncol, 3)).astype(np.float32),
            "y": (rng.random(ncol).astype(np.float32),
                  np.arange(ncol * 2, dtype=np.int32).reshape(ncol, 2))}
    want, n0 = j_pad_columns(jax_tree(tree), multiple)
    got, n1 = pad_columns(tree, multiple)
    assert n0 == n1 == ncol
    for a, b in zip(tree_leaves(got), tree_leaves(jax_tree(want))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(jax_tree(v) for v in tree)
    return jnp.asarray(tree)


def test_shard_columns_splits_every_leaf():
    inp = example_inputs(10, NLEV, device="cpu")
    shards = shard_columns(column_mesh([CPU] * 3), inp)
    assert [s.t.shape[0] for s in shards] == [4, 3, 3]
    assert all(isinstance(s, AtmosInputs) for s in shards)
    for f in inp._fields:
        assert torch.equal(torch.cat([getattr(s, f) for s in shards]),
                           getattr(inp, f)), f


def _refresh(inp):
    cfg = RadiationConfig()
    ple0 = inp.ple[0].numpy()
    ict, icb = cfg.superlayer_indices(0.5 * (ple0[1:] + ple0[:-1]))
    return radiation_refresh(inp, DOY, UTC, config=cfg, ict=ict, icb=icb)


def _states_relmax(got, want):
    return max(relmax(getattr(g, f), getattr(w, f))
               for g, w in zip(got, want) for f in w._fields)


@pytest.fixture(scope="module")
def scene16():
    inp = example_inputs(16, NLEV, device="cpu")
    return inp, _refresh(inp)


def test_sharded_refresh_equals_unsharded(scene16):
    """The refresh of two column shards (a mesh of two CPU devices),
    concatenated, against the refresh of all 16 columns; the padded
    refresh's first 16 columns too."""
    inp, want = scene16
    mesh = column_mesh([CPU, CPU])
    got = run_sharded(_refresh, shard_columns(mesh, inp))
    assert _states_relmax(got, want) <= 5e-5
    padded, ncol = pad_columns(inp, 6)
    assert padded.t.shape[0] == 18 and ncol == 16
    got = run_sharded(_refresh, shard_columns(mesh, padded))
    got = tuple(type(s)(*(x[:ncol] for x in s)) for s in got)
    assert _states_relmax(got, want) <= 5e-5


RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from geosradiation_gridcomp_tpu_torch.config import RadiationConfig
    from geosradiation_gridcomp_tpu_torch.driver.radiation import AtmosInputs
    from geosradiation_gridcomp_tpu_torch.driver.step import radiation_refresh
    from geosradiation_gridcomp_tpu_torch.parallel.distributed import (
        initialize_distributed, process_local_slice)
    from geosradiation_gridcomp_tpu_torch.scene import example_inputs

    torch.set_num_threads(1)
    init, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    assert initialize_distributed(init, 2, rank, backend="gloo") == (rank, 2)
    inp = example_inputs(16, 72, device="cpu")
    start, stop = process_local_slice(16)
    local = AtmosInputs(*(x[start:stop] for x in inp))
    cfg = RadiationConfig()
    ple0 = inp.ple[0].numpy()
    ict, icb = cfg.superlayer_indices(0.5 * (ple0[1:] + ple0[:-1]))
    sol, irr = radiation_refresh(local, 172.0, 12.0, config=cfg, ict=ict,
                                 icb=icb)
    flat = torch.cat([x.reshape(stop - start, -1) for x in (*sol, *irr)],
                     dim=1)
    parts = [torch.empty_like(flat) for _ in range(2)]
    dist.all_gather(parts, flat)
    if rank == 0:
        np.save(out, torch.cat(parts).numpy())
    dist.destroy_process_group()
""")


def test_two_gloo_ranks_match_single_process(scene16, tmp_path):
    """Two processes (gloo, a file:// rendezvous), each refreshing its
    process_local_slice of the 16 x 72 scene; the gathered states against
    the single-process refresh."""
    inp, want = scene16
    init = f"file://{tmp_path / 'rendezvous'}"
    out = tmp_path / "gathered.npy"
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", RANK, init, str(r),
                               str(out)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], errs
    gathered = torch.from_numpy(np.load(out))
    flat = torch.cat([x.reshape(16, -1) for x in (*want[0], *want[1])],
                     dim=1)
    assert gathered.shape == flat.shape
    assert relmax(gathered, flat) <= 5e-5
