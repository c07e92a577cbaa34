"""Cost bisection of the taumol-LW kernel K3 on one NVIDIA GPU.

    python -m geosradiation_gridcomp_tpu_torch.tools.profiling.taumol_lw_bisect
        [--ncol 2048 [8192 ...]]

Port of the reference's tools/profiling/taumol_lw_bisect.py. Each variant
of P3 (models/rrtmg/taumol_lw_cuda.py:taumol_lw_bisect) is K3's body with
parts compiled out (models/rrtmg/taumol_lw.py:VARIANTS): full (K3 itself,
checked bit for bit against K3), no_cont, no_minor, no_planck, maj_only,
minor_only and store_only (the cell loads, the per-cell set-up and the
stores alone). Inputs are the real setcoef_lw coefficients of the
scene.example_inputs scene (seed 0) at ncol x 72, not the reference's
synthetic hash. The reference's nocond and no_scat variants time a TPU
lax.cond and a TPU scatter matmul, which K3 does not have; store_only is
their counterpart here.

Prints each variant's device time (timing.bench_loop) and what the
differences attribute: a part's marginal cost (full - no_part) and its
cost alone (part_only - store_only). Raises if full differs from K3 or
without a CUDA device.
"""

import argparse

import torch

from ...driver import radiation as rad
from ...models.rrtmg import lw as lwm
from ...models.rrtmg.setcoef_lw import setcoef_lw
from ...models.rrtmg.taumol_lw import VARIANTS
from ...models.rrtmg.taumol_lw_cuda import taumol_lw_bisect, taumol_lw_fast
from ...scene import example_inputs
from .timing import bench_loop, card, report

NLAY = 72


def lw_coefs(dev, ncol, nlay=NLAY, seed=0):
    """setcoef_lw of the scene.example_inputs scene (as the refresh forms
    it, without the trace gases the refresh leaves at zero) and the packed
    k-distribution: (coefs, tabs)."""
    inp = example_inputs(ncol, nlay, seed=seed, device=dev)
    lw = lwm.RRTMGLW.from_reference_tables(dev)
    play, h2o, o3 = rad._common_derived(inp)
    tlev = lwm.level_temperatures(play, inp.t, inp.ple * 0.01, inp.tsinst)
    emis = inp.emis[:, None].expand(ncol, 16).contiguous()
    z = torch.zeros_like(inp.co2)
    coefs = setcoef_lw(play, inp.t, inp.ple * 0.01, tlev, inp.tsinst, emis,
                       h2o, o3, inp.co2, inp.ch4, inp.n2o,
                       torch.full_like(z, 0.2095), z, inp.cfc11, inp.cfc12,
                       inp.hcfc22, z, lw.planck_tables)
    return coefs, lw.taumol_tables


def run(dev, ncol, k=20, n=5):
    """Every variant at ncol x 72; returns {variant: ms} with K3's time
    under "k3"."""
    coefs, tabs = lw_coefs(dev, ncol)
    for x, y in zip(taumol_lw_bisect(coefs, tabs, VARIANTS["full"]),
                    taumol_lw_fast(coefs, tabs)):
        if not torch.equal(x, y):
            raise AssertionError("the full variant differs from K3")
    print(f"taumol-LW bisection at {ncol} x {NLAY}:")
    res = {"k3": bench_loop(taumol_lw_fast, coefs, tabs, k=k, n=n)}
    report("K3 taumol_lw_fast", res["k3"], ncol)
    for name, parts in VARIANTS.items():
        res[name] = bench_loop(taumol_lw_bisect, coefs, tabs, parts, k=k,
                               n=n)
        report(name, res[name], ncol)
    for part, no, alone in (("majors", None, "maj_only"),
                            ("minors + halocarbons", "no_minor",
                             "minor_only"),
                            ("continua", "no_cont", None),
                            ("Planck fractions", "no_planck", None)):
        marg = "" if no is None \
            else f"marginal {res['full'] - res[no]:8.3f} ms"
        solo = "" if alone is None \
            else f"alone {res[alone] - res['store_only']:8.3f} ms"
        print(f"  {part:22s} {marg:24s} {solo}")
    print(f"  {'stores + set-up':22s} {'':24s} store_only "
          f"{res['store_only']:8.3f} ms")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ncol", type=int, nargs="+", default=[2048])
    args = ap.parse_args(argv)
    dev, _ = card()
    return {ncol: run(dev, ncol) for ncol in args.ncol}


if __name__ == "__main__":
    main()
