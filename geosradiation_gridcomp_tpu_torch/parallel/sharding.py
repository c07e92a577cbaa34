"""Column sharding over the card(s) of one process.

Port of geosradiation_gridcomp_tpu/parallel/sharding.py. Radiation is
column-local (no halo; SURVEY.md par. 2.8): the horizontal domain
decomposition maps to a 1-D mesh of devices with every per-column tensor
split on its leading axis. JAX runs one SPMD program over the sharded
arrays; here the step runs once per shard, on the shard's device, and the
results are concatenated on the leading axis (run_sharded). No step
crosses columns, so nothing is exchanged between shards.

A "tree" is a tensor, a NamedTuple, dict, list or tuple of trees, or
anything else (passed through unchanged); numpy arrays count as tensors.
"""

import contextlib

import numpy as np
import torch


def tree_map(fn, tree):
    """fn applied to every tensor (or numpy array) of the tree."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def tree_leaves(tree):
    """The tensors (and numpy arrays) of the tree, in order."""
    out = []
    tree_map(out.append, tree)
    return out


def column_mesh(devices=None):
    """1-D mesh (a tuple of torch devices) over every CUDA device, or the
    given ones. Raises where there is no card and no device was given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("column_mesh: no CUDA device; pass the "
                               "devices (e.g. [torch.device('cpu')])")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return tuple(torch.device(d) for d in devices)


def shard_columns(mesh, tree):
    """Split the leading (column) axis of every tensor in the tree across
    the mesh (tensor_split: the first ncol % len(mesh) shards take one
    column more) and start each shard's copy to its device. Returns one
    tree per device."""
    return [tree_map(lambda x, i=i, d=d: torch.as_tensor(x).tensor_split(
        len(mesh))[i].to(d, non_blocking=True), tree)
        for i, d in enumerate(mesh)]


def pad_columns(tree, multiple):
    """Pad the leading axis of every tensor to a multiple (for even
    sharding) by repeating the last column; returns (padded_tree,
    original_ncol)."""
    ncol = tree_leaves(tree)[0].shape[0]
    pad = (-ncol) % multiple
    if pad == 0:
        return tree, ncol

    def f(x):
        x = torch.as_tensor(x)
        return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
    return tree_map(f, tree), ncol


def _on(device):
    """The context that makes device current (CUDA), else nothing."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def run_sharded(step_fn, shards):
    """step_fn on each shard (a tree from shard_columns), with the shard's
    device current, and the outputs concatenated on the leading axis on
    the first shard's device."""
    outs = []
    for shard in shards:
        with _on(tree_leaves(shard)[0].device):
            outs.append(step_fn(shard))
    home = tree_leaves(shards[0])[0].device
    parts = zip(*(tree_leaves(o) for o in outs))
    cat = iter([torch.cat([x.to(home) for x in p]) for p in parts])
    return tree_map(lambda _: next(cat), outs[0])
