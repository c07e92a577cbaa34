"""Runtime input validation + NaN containment.

Port of geosradiation_gridcomp_tpu/driver/validate.py: the reference's
fail-fast input checking, RRTMG-LW's hard `error stop` range asserts on
every input field (rrtmg_lw_rad.F90:209-318) and the VERIFY_/_ASSERT
macros. Two layers:

* `validate_inputs(inp)`: host-side range checks on an AtmosInputs batch
  at the refresh boundary. Raises ValueError naming the offending field,
  its bad extremum and the legal range. Opt-in (it copies the inputs to
  the host).
* `check_finite(tree, what)`: divergence guard on a produced state: any
  non-finite leaf raises FloatingPointError instead of letting NaN fluxes
  propagate into the model.
"""

import numpy as np
import torch

# (field, min, max) physical ranges, after rrtmg_lw_rad.F90:209-318
# (pressures in Pa here, vmr unitless, T in K, radii in micron). Mass
# mixing ratios use generous vmr-equivalent caps.
_RANGES = [
    ("ple", 1.0e-2, 1.1e6),
    ("t", 120.0, 360.0),
    ("qv", 0.0, 0.5),
    ("ql", 0.0, 0.1),
    ("qi", 0.0, 0.1),
    ("qr", 0.0, 0.1),
    ("qs", 0.0, 0.1),
    ("o3", 0.0, 1.0e-2),
    ("fcld", 0.0, 1.0),
    ("ch4", 0.0, 1.0e-3),
    ("n2o", 0.0, 1.0e-3),
    ("cfc11", 0.0, 1.0e-5),
    ("cfc12", 0.0, 1.0e-5),
    ("hcfc22", 0.0, 1.0e-5),
    ("co2", 0.0, 0.1),
    ("ts", 120.0, 360.0),
    ("tsinst", 120.0, 360.0),
    ("t2m", 120.0, 360.0),
    ("emis", 0.0, 1.0),
    ("albvr", 0.0, 1.0),
    ("albvf", 0.0, 1.0),
    ("albnr", 0.0, 1.0),
    ("albnf", 0.0, 1.0),
    ("rl", 0.0, 1000.0),
    ("ri", 0.0, 1000.0),
    ("rr", 0.0, 10000.0),
    ("rs", 0.0, 10000.0),
]


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def validate_inputs(inp):
    """Range-check an AtmosInputs batch on the host.

    Mirrors rrtmg_lw_rad.F90:209-318: every field must be finite and
    inside its physical range; edge pressure must additionally increase
    monotonically from TOA to surface.
    """
    for name, lo, hi in _RANGES:
        a = _host(getattr(inp, name))
        if not np.isfinite(a).all():
            raise ValueError(f"AtmosInputs.{name}: non-finite values")
        amin, amax = float(a.min()), float(a.max())
        if amin < lo or amax > hi:
            raise ValueError(
                f"AtmosInputs.{name}: range [{amin:.6g}, {amax:.6g}] "
                f"outside physical bounds [{lo:.6g}, {hi:.6g}] "
                f"(rrtmg_lw_rad.F90:209-318 equivalent)")
    ple = _host(inp.ple)
    if not (np.diff(ple, axis=-1) > 0.0).all():
        raise ValueError(
            "AtmosInputs.ple: edge pressures must increase TOA->surface")


def _leaves(tree, path=""):
    """(path, leaf) of every leaf of nested NamedTuples, dicts, lists and
    tuples, in the order and with the path names of the reference's
    jax.tree_util walk: `.field`, `['key']` (keys sorted), `[index]`."""
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, value in zip(tree._fields, tree):
            yield from _leaves(value, f"{path}.{name}")
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, f"{path}[{i}]")
    else:
        yield path, tree


def _all_finite(leaf):
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(
            torch.isfinite(leaf).all())
    a = np.asarray(leaf)
    return not np.issubdtype(a.dtype, np.floating) or bool(
        np.isfinite(a).all())


def check_finite(tree, what="radiation state"):
    """Raise FloatingPointError if any floating leaf holds NaN/Inf.

    NaN containment at the refresh boundary: a bad refresh is caught before
    its state replaces the previous good one. UNDEF (1e15) markers are
    legal. Returns the tree untouched, so it chains.
    """
    for name, leaf in _leaves(tree):
        if not _all_finite(leaf):
            raise FloatingPointError(
                f"{what}{name}: non-finite values after refresh")
    return tree
