"""Check and time the McICA kernel K1 and the forward fill P1 on one NVIDIA
GPU, on the reference tool's synthetic scene.

    python -m \
        geosradiation_gridcomp_tpu_torch.tools.profiling.fused_mcica_check \
        [--ncol 2048]

Port of the reference's tools/profiling/fused_mcica_check.py, with its
scene (:27-53: 72 layers, cloud decks at layers 30-39 and 55-59, 140
subcolumns, numpy seed 0):

1. P1 (ops/ffill_cuda.py:ffill) on [8, 72, 140] against ops.mcica.
   _correlate on the transposed layout: exact. The reference tool filled
   [8, 140, 72] arrays, that is along the subcolumn axis, and compared
   with a fill along the layers; this fills along the layers.
2. The zcw polynomial fit of the TPU kernels (ops/zcw_fit.py) against the
   exact class table, per sigma class: max and mean |difference|.
3. K1 (ops/mcica_cuda.py:mcica_optics_lw): determinism and
   column-permutation invariance, exact.
4. Population statistics of K1 and of its plain twin: subcolumn cloud
   fraction against the input, the cloudy-cell taucmc moments, the clear
   counts of column 0 (K1 draws the twin's stream, so they agree).
5. Time per call of K1 and of its twin, each call's output feeding the
   next (timing.bench_carry).

Raises if a check that must be exact fails, or without a CUDA device.
"""

import argparse

import numpy as np
import torch

from ...models.rrtmg.cldprmc_lw import band_abs_coeffs_lw, lw_cloud_tables
from ...ops import mcica
from ...ops.ffill_cuda import ffill, ffill_plain
from ...ops.mcica_cuda import mcica_optics_lw, mcica_optics_lw_plain
from ...ops.zcw_fit import zcw_eval, zcw_fit
from .timing import bench_carry, card

NSUB, NLAY = 140, 72
DOY = 172.0


def scene(ncol, dev):
    """The reference tool's scene (fused_mcica_check.py:27-53) and the rng
    it leaves behind."""
    rng = np.random.default_rng(0)
    play = (np.linspace(2.0, 1000.0, NLAY)[None, :]
            + rng.random((ncol, NLAY)) * 1.0).astype(np.float32)
    zmid = (-7200.0 * np.log(play / 1013.0)).astype(np.float32)
    cldf = np.zeros((ncol, NLAY), np.float32)
    cldf[:, 30:40] = rng.uniform(0.2, 0.95, (ncol, 10))
    cldf[:, 55:60] = rng.uniform(0.1, 0.6, (ncol, 5))
    ciwp = np.where(cldf > 0, rng.uniform(1.0, 40.0, cldf.shape), 0.0)
    clwp = np.where(cldf > 0, rng.uniform(1.0, 60.0, cldf.shape), 0.0)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    s = dict(play=t(play), zmid=t(zmid), cldf=t(cldf), ciwp=t(ciwp),
             clwp=t(clwp), rei=t(np.full((ncol, NLAY), 30.0)),
             rel=t(np.full((ncol, NLAY), 12.0)),
             alat=t(np.linspace(-1.2, 1.2, ncol)))
    return s, rng


def k1_args(s, dev):
    """K1's arguments for the scene (beta condensate PDF)."""
    alpha, rcorr = mcica.overlap_params(s["zmid"], s["alat"], DOY)
    absi, absl = band_abs_coeffs_lw(s["rei"], s["rel"], lw_cloud_tables(dev))
    return (s["play"], alpha, rcorr, s["cldf"],
            s["ciwp"], s["clwp"], mcica._sigma_class(s["cldf"]),
            absi.contiguous(), absl.contiguous(),
            torch.as_tensor(mcica.zcw_class_columns(1), device=dev))


def run(dev, ncol, k=10, n=3):
    """Every check and timing; returns a dict of the numbers printed."""
    s, rng = scene(ncol, dev)
    res = {}

    v = torch.as_tensor(rng.random((8, NLAY, NSUB)).astype(np.float32),
                        device=dev)
    keep = torch.as_tensor((rng.random((8, NLAY, NSUB)) > 0.6)
                           .astype(np.float32), device=dev)
    got, want = ffill(v, keep), ffill_plain(v, keep)
    res["ffill_err"] = float((got - want).abs().max())
    print(f"ffill max err: {res['ffill_err']}")
    if not torch.equal(got, want):
        raise AssertionError("P1 differs from _correlate")

    fit = zcw_fit(1)
    cols = torch.as_tensor(mcica.zcw_class_columns(1), device=dev)
    vv = torch.as_tensor(rng.random((4, NLAY, 64)).astype(np.float32),
                         device=dev)
    for cls in range(3):
        c = torch.full((4, NLAY, 1), cls, device=dev)
        d = (zcw_eval(vv, (c == 0, c == 1), fit)
             - mcica.zcw_lookup_class(vv, c.expand_as(vv), cols)).abs()
        res[f"zcw_class{cls}_max"] = float(d.max())
        print(f"zcw class {cls}: max|d|={float(d.max()):.2e} "
              f"mean|d|={float(d.mean()):.2e}")

    args = k1_args(s, dev)
    kw = dict(cloud_mh=28, cloud_lm=47)
    tau, cloudy, counts = mcica_optics_lw(*args, **kw)
    tau2, _, _ = mcica_optics_lw(*args, **kw)
    perm = torch.as_tensor(rng.permutation(ncol), device=dev)
    tau_p, _, _ = mcica_optics_lw(*(x[perm].contiguous() for x in args[:9]),
                                  args[9], **kw)
    res["determinism"] = torch.equal(tau, tau2)
    res["perm_invariance"] = torch.equal(tau_p, tau[perm])
    print(f"determinism: {res['determinism']}")
    print(f"decomposition invariance: {res['perm_invariance']}")
    if not (res["determinism"] and res["perm_invariance"]):
        raise AssertionError("K1 is not deterministic and invariant")

    tau_o, _, counts_o = mcica_optics_lw_plain(*args, **kw)
    sel = s["cldf"] > 0
    for name, t in (("fused", tau), ("plain", tau_o)):
        cf = (t > 0).double().mean(dim=2)
        err = float((cf[sel] - s["cldf"][sel].double()).abs().mean())
        pos = t[t > 0].double()
        res[f"pop_err_{name}"] = err
        print(f"cloud-fraction pop err ({name} vs input): {err:.4f}; "
              f"taucmc cloudy-cell moments ({float(pos.mean()):.4f}, "
              f"{float(pos.std()):.4f})")
    print(f"counts row0: {counts[0].tolist()}  plain: "
          f"{counts_o[0].tolist()}")
    if not torch.equal(counts, counts_o):
        raise AssertionError("K1's clear counts differ from the twin's")

    def step(mcica_fn):
        def f(cf):
            t, _, _ = mcica_fn(args[0], args[1], args[2], cf, *args[4:],
                               **kw)
            return cf + 1e-12 * t[:, :, 0]
        return f
    res["k1_ms"] = bench_carry(step(mcica_optics_lw), s["cldf"], k=k, n=n)
    res["plain_ms"] = bench_carry(step(mcica_optics_lw_plain), s["cldf"],
                                  k=max(1, k // 5), n=n)
    for name in ("k1", "plain"):
        ms = res[f"{name}_ms"]
        print(f"{'K1 mcica+cldprmc' if name == 'k1' else 'plain twin':20s}"
              f" {ms:.3f} ms ({ncol / (ms * 1e-3):.0f} cols/s)")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ncol", type=int, default=2048)
    args = ap.parse_args(argv)
    dev, _ = card()
    return run(dev, args.ncol)


if __name__ == "__main__":
    main()
