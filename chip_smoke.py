#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1 McICA + LW cloud optics, K2 McICA + SW
cloud optics, K3 taumol-LW, K4 rtrnmc, K5 taumol-SW, K6 spcvmc, K7 raw
McICA draws, P1 forward fill, P2 table gathers, P3 taumol-LW bisection)
from geosradiation_gridcomp_tpu_torch/csrc with nvcc for sm_90a, one
nvcc per source side by side, then:

1. step phase at 8192 columns x 72 levels (the reference benchmark's
   workload, bench.py:190-228): radiation_refresh + radiation_update
   through their entry points on the realistic multi-deck scene, doy 172,
   12 UTC, with sw_partition_bounds daylight packing; every kernel K1-K6
   must launch, and the first call of each one's wrapper is recorded;
   every IrradState field and LW export must agree with the plain path on
   the same card to relmax <= 5e-5, every SolarState field and SW export
   to relmax <= 5e-4 with at most 0.5 % of columns beyond 5e-5
   (tools/verify_tpu.py:279-281); the heating rates in the reference's
   form (tests/test_accuracy.py:142-152): the flux-divergence error in
   every layer and the relative rate where dp > 100 Pa, each within the
   bound the flux gates imply (heating_rate_gates); fluxes must be
   physical; the wall time of the refresh with the kernels and with the
   plain twins;
2. kernel phases of K1-K6 at the main path's shapes, on the inputs the
   refresh gave them: each kernel against its plain PyTorch twin on the
   same inputs on the card (K1, K2: cloudy masks and clear counts
   identical, cloud optics relmax <= 1e-5; K3, K5 relmax <= 5e-4 in every
   band, K3 also with an aerosol depth; K4 relmax <= 5e-4 for every
   output and equal to itself over two runs; K6 likewise, also with
   aerosol and with ncld 512), with both times (CUDA events) and the
   kernel's bound: bytes over the memory rate, or the work, whichever is
   larger;
   the work is operations over the FP32 peak, and for the threefry draws
   of K1, K2 and K7 (with K1 and K2's subkeys) the SASS instructions of
   one draw as nvcc compiles it in this run, over the rates of the SM's
   pipes; then K1, K2, K4, K5 and K6's wrappers once more on those inputs
   under
   torch.cuda.set_sync_debug_mode("error"), where any call that
   synchronises the stream (a copy from host memory) raises;
3. kernel phases of the verification and profiling kernels at the sizes
   their paths give them, each against its plain twin on the same inputs,
   with both times and the bound: K7 at 512 x 72 and P1 on [1024, 72, 140]
   exactly equal; P2's gather_rows and gather_lanes at the profiling
   tool's 8192 x 72 points exactly equal, gather_rows beside the library
   call tab[idx]; P3's full variant equal to K3 bit for bit and every
   variant within relmax 5e-4 of its twin in every band, at 1024 x 72;
4. verify path: the verification suite's entry point
   (tools/verify.py --quick, 512 x 72), every gate passing; K7 must
   launch there;
5. profiling path: the three profiling entry points (fused_mcica_check
   at 1024 columns, gather_micro at its default size, taumol_lw_bisect
   at 1024 x 72), each raising on a failed check; P1, both P2 kernels and
   P3 must launch there.

Then it checks that neither jax nor any module of the reference package
geosradiation_gridcomp_tpu was loaded.

    python3 chip_smoke.py --profile

adds, after the step phase, where the time of the full-width refresh
goes: its wall time over 30 runs, the device time of each CUDA kernel,
the launches per refresh and the device's idle share (torch.profiler),
a check that the refresh calls neither ops.mcica.subcolumn_keys nor
band_optics_coeffs_sw (K1 and K2 derive the subkeys, K2 the SW band
optics, on the card), and the solar_refresh and irrad_refresh stages
alone, beside subcolumn_keys, now off the kernel path (CUDA events).

Prints the card's name and power limit, a JSON line with each kernel's
launches (counted on the path named by its `path`: step, verify or
profiling; launches_per_refresh for the step kernels), error, times,
bound and library time, and as its last line
{"ok": true, "device": {...}}. Any failure raises (exit code != 0).
relmax is max|a - b| / max|b|, as the reference's tools/verify_tpu.py.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

NCOL_KERNEL = 1024
NCOL_VERIFY = 512
NCOL_SLICE = 8192
NLEV = 72
SEED = 0
DOY = 172.0
UTC = 12.0


def relmax(a, b, floor=1e-6):
    a = a.double()
    b = b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), floor))


def band_relmax(a, b, ngs):
    """Largest relmax over the bands' g-point slices; ngs: band starts."""
    return max(relmax(a[..., ngs[i]:ngs[i + 1]], b[..., ngs[i]:ngs[i + 1]])
               for i in range(len(ngs) - 1))


def flipped_share(a, b, limit=5e-5):
    """Share of columns whose largest error exceeds limit times max|b|."""
    err = (a.double() - b.double()).abs().reshape(a.shape[0], -1)
    scale = max(float(b.double().abs().max()), 1e-6)
    return float((err.max(dim=1).values / scale > limit).double().mean())


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def gate(name, value, limit):
    ok = value <= limit
    print(f"  {name:36s} {value:.3e} <= {limit:.0e}  "
          f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {value:.3e} > {limit:.0e}")


def heating_rate_gates(dtdt, dtdt_ref, ple, fsw_ref, flw_ref, tol_sw,
                       tol_lw):
    """The heating rates in the reference's form (tests/test_accuracy.py:
    142-152): the error of the flux divergence in every layer, and the
    relative rate where dp > 100 Pa.

    dtdt = GRAV / (CP dp) times the difference of the SW+LW net flux
    between a layer's levels, so |error| * dp is GRAV / CP times the error
    of two flux differences: where the fsw and flw exports pass their
    relmax gates tol_sw and tol_lw, it is at most
    B = 2 (tol_sw max|fsw| + tol_lw max|flw|) GRAV / CP in every layer,
    the model-top layers of a few Pa included. In a layer thicker than
    100 Pa the rate's error is then at most B / 100 Pa; relative to the
    largest rate of those layers that is the relative bound."""
    from geosradiation_gridcomp_tpu_torch.constants import CP, GRAV

    dp = (ple[:, 1:] - ple[:, :-1]).double()
    err = (dtdt.double() - dtdt_ref.double()).abs()
    div = 2.0 * (tol_sw * float(fsw_ref.abs().max())
                 + tol_lw * float(flw_ref.abs().max())) * GRAV / CP
    gate("heating rates: |error| x dp, every layer", float((err * dp).max()),
         div)
    deep = dp > 100.0
    top = float(dtdt_ref[deep].double().abs().max())
    gate("heating rates: relmax where dp > 100 Pa",
         float(err[deep].max()) / top, div / (100.0 * top))


def time_ms(torch, fn, n):
    """Mean device time of fn over n runs (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# device memory, and FP32 outside the tensor cores with an FMA counted as
# two operations.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Thread-instructions each pipe of an SM completes per clock (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0): 128 FP32 add, multiply or FMA; 64 of the 32-bit integer add, logic,
# shift and compare (alu); 64 integer multiply-add (IMAD, on the heavy half
# of the FMA pipe, beside the alu's); 16 MUFU. Each of the 4 sub-partitions
# issues one warp instruction per clock: 128 in all. The SM-clocks per
# second (132 SMs at the boost clock) follow from the FP32 peak, 128 FMA
# per SM-clock.
SM_CLOCKS_PER_S = FP32_OPS_PER_S / (2 * 128)
PIPES = {"alu": (("alu",), 64), "fmaheavy": (("imad",), 64),
         "fma": (("fp32", "imad"), 128), "mufu": (("mufu",), 16)}
DISPATCH_PER_CLOCK = 128
# operations per unit of work, read off the kernels' sources (an exp, a
# division or a square root counted as one operation); the threefry draws
# of K1, K2 and K7 are counted in SASS instructions instead, compiled by
# kernel_resources.threefry_counts in this run
MCICA_INSNS = 10       # fp32 zcw lookup and cloud optics per (cell,
#                        subcolumn)
MCICA_SW_INSNS = 16    # K2 per (cell, subcolumn): zcw lookup (5), the
#                        four water-path products, two floors, two
#                        divisions (each a reciprocal and a product), the
#                        asymmetry numerator (3)
SW_BAND_OPS = 60       # K2's prologue per (cell, band): the radius
#                        factors and indices, 7 row interpolations (3
#                        each), Fu's forward fraction, the two phases'
#                        delta folding (2 divisions and 8 operations each)
KEY_DRAWS = 8          # threefry calls of one column's subkeys: 4 fold_in
#                        and a split into 4
TAUMOL_LW_OPS = 40     # per (cell, g-point): ~12 table terms, weights, sums
TAUMOL_SW_OPS = 30     # per (cell, g-point)
RTRNMC_OPS = 60        # per (cell, g-point): both sweeps, exp, Planck terms
SPCVMC_OPS = 130       # per (cell, g-point, stream): optics, one reftra
#                        (~90), both adding steps and the level fluxes


def issue_seconds(counts, n):
    """Least time (s) for the SMs to run n times the thread-instructions
    of counts (kernel_resources.PIPE_CLASSES -> count): the busiest pipe's
    time or the time to issue them all, whichever is longer."""
    clocks = max([sum(counts.get(c, 0) for c in cls) / rate
                  for cls, rate in PIPES.values()]
                 + [sum(counts.values()) / DISPATCH_PER_CLOCK])
    return n * clocks / SM_CLOCKS_PER_S


def nbytes(*xs):
    """Bytes of every tensor in xs (tuples, lists and dicts searched)."""
    total = 0
    for x in xs:
        if hasattr(x, "element_size"):
            total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            total += nbytes(*x.values())
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
    return total


def bound(nbytes_, fp_ops=0.0, seconds=0.0):
    """The least time (ms) the card needs to move nbytes_ (each input read
    once, each output written once) or do the work (fp_ops operations at
    the FP32 peak, or `seconds` of instruction issue), whichever is larger,
    and which of the two it is."""
    t_bytes = nbytes_ / HBM_BYTES_PER_S
    t_ops = max(fp_ops / FP32_OPS_PER_S, seconds)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def draw_counts(draw, draws, extra=None):
    """Thread-instructions of `draws` threefry draws (draw: one draw's, by
    class) and the extra ones, by class."""
    out = {c: draws * n for c, n in draw.items()}
    for c, n in (extra or {}).items():
        out[c] = out.get(c, 0) + n
    return out


def mcica_bound(args, kw, out, ng, draw):
    """K1, K2: the inputs (play in place of the subkeys; K2 also rei, rel
    and its packed tables in place of the band planes) and the outputs,
    or the work of the columns with cloud (the kernels skip the others):
    their subkeys, the draws and the per-cell arithmetic, and K2's
    prologue, the band optics of each (cell, band)."""
    cldf = args[3]
    ncloudy = int((cldf > 0.0).any(dim=1).sum())
    draws = 2 + (2 if kw.get("inhm", 1) != 0 else 0)
    cells = ncloudy * cldf.shape[1]
    sw = ng == 112
    work = draw_counts(draw, draws * cells * ng + KEY_DRAWS * ncloudy, {
        "fp32": (MCICA_SW_INSNS if sw else MCICA_INSNS) * cells * ng
        + (SW_BAND_OPS * cells * 14 if sw else 0)})
    return bound(nbytes(args, out), seconds=issue_seconds(work, 1))


def taumol_bound(coefs, fields, tabs, ng, ops, out, taua=None):
    """K3, K5, P3: the per-cell fields the kernel reads (as the caller
    holds them), the tables, the outputs."""
    return bound(nbytes([getattr(coefs, k) for k in fields], tabs.pack, taua,
                        out),
                 fp_ops=coefs.jp.numel() * ng * ops)


def spcvmc_bound(args, kw, out):
    """K6: the clear stream on every column, the all-sky one on the first
    ncld; cloud optics read where the all-sky stream sees cloud."""
    (_, taug, taur, sfluxzen, mu0, albdir, albdif, cldymc, taucmc, _,
     _) = args
    ncol, nlay, ng = taug.shape
    ncld = ncol if kw.get("ncld") is None else min(kw["ncld"], ncol)
    ncloudy = int(cldymc[:ncld].sum())
    aero = [kw.get(k) for k in ("taua", "ssaa", "asya")]
    moved = (nbytes(taug, taur, sfluxzen, mu0, albdir, albdif, aero, out)
             + cldymc[:ncld].numel() + 3 * 4 * ncloudy)
    return bound(moved, fp_ops=(ncol + ncld) * nlay * ng * SPCVMC_OPS)


def step_kernel_phases(torch, dev, calls, draw):
    """Each step kernel (K1-K6) on the inputs the full-width refresh gave
    it, against its plain twin on the same inputs, with both times and
    its bound; draw: one threefry draw's instructions by class."""
    from geosradiation_gridcomp_tpu_torch.models.rrtmg import (
        taumol_lw_cuda, taumol_sw_cuda)
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.rtrnmc import rtrnmc
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.spcvmc import \
        spcvmc_sw
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw import (
        NGS_LW, taumol_lw)
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_sw import (
        NGS_SW, taumol_sw)
    from geosradiation_gridcomp_tpu_torch.ops.mcica_cuda import (
        mcica_optics_lw_plain, mcica_optics_sw_plain)

    results = {}

    def timed(name, fn, plain, args, kw, err, bnd):
        results[name] = dict(
            max_abs_err=err, ms=time_ms(torch, lambda: fn(*args, **kw), 20),
            plain_ms=time_ms(torch, lambda: plain(*args, **kw), 3),
            bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
        print(f"  {results[name]['ms']:.4f} ms (plain "
              f"{results[name]['plain_ms']:.2f} ms), bound "
              f"{bnd[0]:.4f} ms by {bnd[1]}")

    for name, plain, ng in (("mcica_optics_lw", mcica_optics_lw_plain, 140),
                            ("mcica_optics_sw", mcica_optics_sw_plain, 112)):
        fn, args, kw = calls[name]
        print(f"{name} at {tuple(args[3].shape)}:")
        out_k, out_p = fn(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        nopt = len(out_p) - 2
        gate("cloudy mask mismatches",
             float((out_k[nopt] != out_p[nopt]).sum()), 0)
        gate("clear count mismatches",
             float((out_k[nopt + 1] != out_p[nopt + 1]).sum()), 0)
        for i in range(nopt):
            gate(f"optics {i} relmax", relmax(out_k[i], out_p[i]), 1e-5)
        timed(name, fn, plain, args, kw,
              max(max_abs(a, b) for a, b in zip(out_k[:nopt], out_p[:nopt])),
              mcica_bound(args, kw, out_k, ng, draw))

    fn, args, kw = calls["taumol_lw"]
    coefs, tabs = args[0], args[1]
    print(f"taumol_lw at {tuple(coefs.jp.shape)}:")
    tg_k, pf_k = fn(*args, **kw)
    tg_p, pf_p = taumol_lw(*args, **kw)
    gate("taug relmax, worst band", band_relmax(tg_k, tg_p, NGS_LW), 5e-4)
    gate("pfracs relmax, worst band", band_relmax(pf_k, pf_p, NGS_LW), 5e-4)
    gen = torch.Generator(dev).manual_seed(SEED)
    taua = 0.02 * torch.rand(coefs.jp.shape + (16,), device=dev,
                             generator=gen)
    gate("taug relmax with taua, worst band",
         band_relmax(fn(coefs, tabs, taua)[0], taumol_lw(coefs, tabs, taua)[0],
                     NGS_LW), 5e-4)
    fields = taumol_lw_cuda.FLOAT_FIELDS + taumol_lw_cuda.INT_FIELDS
    timed("taumol_lw", fn, taumol_lw, args, kw,
          max(max_abs(tg_k, tg_p), max_abs(pf_k, pf_p)),
          taumol_bound(coefs, fields, tabs, 140, TAUMOL_LW_OPS, (tg_k, pf_k),
                       args[2] if len(args) > 2 else None))

    fn, args, kw = calls["rtrnmc"]
    print(f"rtrnmc at {tuple(args[1].shape)}:")
    out_k, out_p = fn(*args, **kw), rtrnmc(*args, **kw)
    for k in out_p:
        gate(f"{k} relmax", relmax(out_k[k], out_p[k]), 5e-4)
    again = fn(*args, **kw)
    gate("run-to-run mismatches",
         float(sum(int((out_k[k] != again[k]).sum()) for k in out_k)), 0)
    timed("rtrnmc", fn, rtrnmc, args, kw,
          max(max_abs(out_k[k], out_p[k]) for k in out_p),
          bound(nbytes(args, out_k),
                fp_ops=args[1].numel() * RTRNMC_OPS))

    fn, args, kw = calls["taumol_sw"]
    coefs, tabs = args
    print(f"taumol_sw at {tuple(coefs.jp.shape)}:")
    tg_k, tr_k = fn(*args, **kw)
    tg_p, tr_p = taumol_sw(*args, **kw)
    gate("taug relmax, worst band", band_relmax(tg_k, tg_p, NGS_SW), 5e-4)
    gate("taur relmax, worst band", band_relmax(tr_k, tr_p, NGS_SW), 5e-4)
    fields = taumol_sw_cuda.FLOAT_FIELDS + taumol_sw_cuda.INT_FIELDS
    timed("taumol_sw", fn, taumol_sw, args, kw,
          max(max_abs(tg_k, tg_p), max_abs(tr_k, tr_p)),
          taumol_bound(coefs, fields, tabs, 112, TAUMOL_SW_OPS,
                       (tg_k, tr_k)))

    fn, args, kw = calls["spcvmc"]
    ncol = args[1].shape[0]
    print(f"spcvmc at {tuple(args[1].shape)}, ncld {kw.get('ncld')}:")
    gen = torch.Generator(dev).manual_seed(SEED)
    rnd = lambda lo, hi: lo + (hi - lo) * torch.rand(
        ncol, NLEV, 14, device=dev, generator=gen)
    aero = dict(taua=rnd(0.0, 0.1), ssaa=rnd(0.8, 1.0), asya=rnd(0.5, 0.8))
    err = 0.0
    for label, extra in (("", {}), (" with aerosol", aero),
                         (" with ncld 512", dict(ncld=512))):
        a = fn(*args, **{**kw, **extra})
        b = spcvmc_sw(*args, **{**kw, **extra})
        gate(f"worst output relmax{label}",
             max(relmax(a[k], b[k]) for k in b), 5e-4)
        err = max(err, max(max_abs(a[k], b[k]) for k in b))
    a, again = fn(*args, **kw), fn(*args, **kw)
    gate("run-to-run mismatches",
         float(sum(int((a[k] != again[k]).sum()) for k in a)), 0)
    timed("spcvmc", fn, spcvmc_sw, args, kw, err, spcvmc_bound(args, kw, a))
    return results


def sync_free_phase(torch, calls):
    """K1, K2, K4, K5 and K6's wrappers on the refresh's inputs under
    set_sync_debug_mode("error"): a wrapper that synchronises the stream
    (a copy from host memory, a read of a device value) fails."""
    from geosradiation_gridcomp_tpu_torch.tools.profiling.kernel_ab import \
        sync_free

    print("sync-free wrappers, set_sync_debug_mode('error'):")
    for name in ("mcica_optics_lw", "mcica_optics_sw", "rtrnmc",
                 "taumol_sw", "spcvmc"):
        fn, args, kw = calls[name]
        res = sync_free(torch, lambda: fn(*args, **kw))
        print(f"  {name:36s} {'PASS' if res is True else res}")
        if res is not True:
            raise AssertionError(f"{name}: {res}")


def raw_and_profiling_kernel_phases(torch, dev, draw):
    """K7, P1, P2 and P3 against their plain twins at the sizes their
    paths give them: K7 at the verification suite's --quick 512 x NLEV,
    P1 and P3 at the profiling tools' NCOL_KERNEL x NLEV, P2 at the
    gather tool's 8192 x NLEV points."""
    from geosradiation_gridcomp_tpu_torch.driver import radiation as rad
    from geosradiation_gridcomp_tpu_torch.models.rrtmg import lw as lwm
    from geosradiation_gridcomp_tpu_torch.models.rrtmg import taumol_lw_cuda
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw import (
        NGS_LW, VARIANTS, taumol_lw)
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw_cuda import (
        taumol_lw_bisect, taumol_lw_fast)
    from geosradiation_gridcomp_tpu_torch.ops import mcica
    from geosradiation_gridcomp_tpu_torch.ops.ffill_cuda import (ffill,
                                                                 ffill_plain)
    from geosradiation_gridcomp_tpu_torch.ops.gather_cuda import (
        gather_lanes, gather_lanes_plain, gather_rows, gather_rows_plain)
    from geosradiation_gridcomp_tpu_torch.ops.mcica_cuda import (
        mcica_subcols_raw, mcica_subcols_raw_plain)
    from geosradiation_gridcomp_tpu_torch.scene import example_inputs
    from geosradiation_gridcomp_tpu_torch.tools.profiling.taumol_lw_bisect \
        import lw_coefs

    ncol = NCOL_KERNEL
    results = {}

    def timed(name, fn, plain, err, bnd, n_plain=3, library=None):
        results[name] = dict(
            max_abs_err=err, ms=time_ms(torch, fn, 20),
            plain_ms=time_ms(torch, plain, n_plain), bound_ms=bnd[0],
            bound_by=bnd[1],
            library_ms=None if library is None else time_ms(torch, library,
                                                            20))

    def exact(name, a, b):
        gate(f"{name} mismatches", float((a != b).sum()), 0)
        return max_abs(a, b)

    inp = example_inputs(NCOL_VERIFY, NLEV, seed=SEED, device=dev)
    play = rad._common_derived(inp)[0]
    zm = lwm.mid_heights(play, inp.t, inp.ple[..., -1])
    alpha, rcorr = mcica.overlap_params(zm, inp.lats, DOY)
    k7_args = (mcica.subcolumn_keys(play), alpha, rcorr, inp.fcld)
    print(f"K7 mcica_subcols_raw at {NCOL_VERIFY} x {NLEV}:")
    a = mcica_subcols_raw(*k7_args, nsub=140)
    b = mcica_subcols_raw_plain(*k7_args, nsub=140)
    # four draws per (cell, subcolumn), every column
    timed("mcica_subcols_raw",
          lambda: mcica_subcols_raw(*k7_args, nsub=140),
          lambda: mcica_subcols_raw_plain(*k7_args, nsub=140),
          max(exact("cloudy", a[0], b[0]), exact("v3", a[1], b[1])),
          bound(nbytes(k7_args, a), seconds=issue_seconds(
              draw_counts(draw, 4), inp.fcld.numel() * 140)))

    gen = torch.Generator(dev).manual_seed(SEED)
    v = torch.rand(ncol, NLEV, 140, device=dev, generator=gen)
    keep = (torch.rand(ncol, NLEV, 140, device=dev, generator=gen)
            > 0.6).float()
    print(f"P1 ffill on [{ncol}, {NLEV}, 140]:")
    out = ffill(v, keep)
    timed("ffill", lambda: ffill(v, keep), lambda: ffill_plain(v, keep),
          exact("ffill", out, ffill_plain(v, keep)),
          bound(nbytes(v, keep, out), fp_ops=v.numel()))

    n, rows = 8192 * NLEV, 585
    tab = torch.randn(rows, 16, device=dev, generator=gen)
    tabt = torch.nn.functional.pad(tab.T, (0, 640 - rows)).contiguous()
    idx = torch.randint(0, rows, (n,), device=dev, generator=gen,
                        dtype=torch.int32)
    idx2d = idx.reshape(-1, 128)
    print(f"P2 gather_rows, gather_lanes at {n} points, {rows} x 16 table:")
    out = gather_rows(idx, tab)
    # the library call: PyTorch's advanced indexing, tab[idx]
    timed("gather_rows", lambda: gather_rows(idx, tab),
          lambda: gather_rows_plain(idx, tab),
          exact("gather_rows", out, gather_rows_plain(idx, tab)),
          bound(nbytes(idx, tab, out)), n_plain=20,
          library=lambda: tab[idx])
    out = gather_lanes(idx2d, tabt)
    timed("gather_lanes", lambda: gather_lanes(idx2d, tabt),
          lambda: gather_lanes_plain(idx2d, tabt),
          exact("gather_lanes", out, gather_lanes_plain(idx2d, tabt)),
          bound(nbytes(idx2d, tabt, out)), n_plain=20)

    coefs, tabs = lw_coefs(dev, ncol)
    print(f"P3 taumol_lw_bisect at {ncol} x {NLEV}:")
    k3 = taumol_lw_fast(coefs, tabs)
    full = taumol_lw_bisect(coefs, tabs, VARIANTS["full"])
    for name, x, y in zip(("taug", "pfracs"), full, k3):
        exact(f"full vs K3 {name}", x, y)
    err = 0.0
    for name, parts in VARIANTS.items():
        tg_k, pf_k = taumol_lw_bisect(coefs, tabs, parts)
        tg_p, pf_p = taumol_lw(coefs, tabs, parts=parts)
        gate(f"{name} taug relmax, worst band",
             band_relmax(tg_k, tg_p, NGS_LW), 5e-4)
        gate(f"{name} pfracs relmax, worst band",
             band_relmax(pf_k, pf_p, NGS_LW), 5e-4)
        err = max(err, max_abs(tg_k, tg_p), max_abs(pf_k, pf_p))
        ms = time_ms(torch, lambda: taumol_lw_bisect(coefs, tabs, parts), 20)
        print(f"  {name}: {ms:.4f} ms")
    timed("taumol_lw_bisect",
          lambda: taumol_lw_bisect(coefs, tabs, VARIANTS["full"]),
          lambda: taumol_lw(coefs, tabs), err,
          taumol_bound(coefs, taumol_lw_cuda.FLOAT_FIELDS
                       + taumol_lw_cuda.INT_FIELDS, tabs, 140, TAUMOL_LW_OPS,
                       full))
    return results


def verify_path(torch):
    """The verification suite through its entry point, at --quick size;
    returns the launches it made."""
    from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
    from geosradiation_gridcomp_tpu_torch.tools import verify

    print("verify: python -m geosradiation_gridcomp_tpu_torch.tools.verify "
          "--quick")
    torch.cuda.synchronize()
    LAUNCHES.clear()
    verify.main(["--quick"])
    torch.cuda.synchronize()
    return dict(LAUNCHES)


def profiling_path(torch):
    """The three profiling entry points; returns the launches they made."""
    from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
    from geosradiation_gridcomp_tpu_torch.tools.profiling import (
        fused_mcica_check, gather_micro, taumol_lw_bisect)

    print("profiling: fused_mcica_check --ncol 1024, gather_micro, "
          "taumol_lw_bisect --ncol 1024")
    torch.cuda.synchronize()
    LAUNCHES.clear()
    fused_mcica_check.main(["--ncol", str(NCOL_KERNEL)])
    gather_micro.main([])
    taumol_lw_bisect.main(["--ncol", str(NCOL_KERNEL)])
    torch.cuda.synchronize()
    return dict(LAUNCHES)


def step_phase(torch, dev):
    """radiation_refresh + radiation_update at full width through their
    entry points, as bench.py drives the reference; returns the launches,
    the step's set-up and the recorded first call of each step kernel."""
    from geosradiation_gridcomp_tpu_torch.config import RadiationConfig
    from geosradiation_gridcomp_tpu_torch.driver.step import (
        radiation_refresh, radiation_update, sw_partition_bounds)
    from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.lw import RRTMGLW
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.sw import RRTMGSW
    from geosradiation_gridcomp_tpu_torch.scene import example_inputs
    from geosradiation_gridcomp_tpu_torch.tools.profiling.kernel_ab import \
        recording

    ncol = NCOL_SLICE
    inp = example_inputs(ncol, NLEV, seed=SEED, device=dev)
    cfg = RadiationConfig()
    ple0 = inp.ple[0].cpu().numpy()
    ict, icb = cfg.superlayer_indices(0.5 * (ple0[1:] + ple0[:-1]))
    # bench.py's bounds: the larger over the benchmark's doy range
    bounds = [sw_partition_bounds(inp.lons, inp.lats, inp.fcld, d, UTC, cfg)
              for d in (DOY, DOY + 0.01)]
    nlit = None if any(b[0] is None for b in bounds) \
        else max(b[0] for b in bounds)
    ncld = None if any(b[1] is None for b in bounds) \
        else max(b[1] for b in bounds)
    mods = dict(sw=RRTMGSW.from_reference_tables(dev),
                lw=RRTMGLW.from_reference_tables(dev))

    def refresh(plain):
        return radiation_refresh(inp, DOY, UTC, config=cfg, ict=ict, icb=icb,
                                 sw_nlit=nlit, sw_ncld=ncld, plain=plain,
                                 **mods)

    def run(plain):
        sol, irr = refresh(plain)
        upd = radiation_update(sol, irr, inp.tsinst + 0.5, inp.lons,
                               inp.lats, inp.ple, DOY, UTC + 0.25, config=cfg)
        return sol, irr, upd

    print(f"step: radiation_refresh + radiation_update at {ncol} x {NLEV}, "
          f"ict={ict} icb={icb}, sw_nlit={nlit} sw_ncld={ncld}:")
    with recording() as calls:
        torch.cuda.synchronize()
        LAUNCHES.clear()
        sol, irr, upd = run(plain=False)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    print(f"  kernel launches in the main path: {launches}")
    require_launched(launches, "step")
    sol_p, irr_p, upd_p = run(plain=True)
    for f in irr._fields:
        gate(f"IrradState.{f} relmax", relmax(getattr(irr, f),
                                              getattr(irr_p, f)), 5e-5)
    for k in upd["lw"]:
        gate(f"lw export {k} relmax", relmax(upd["lw"][k], upd_p["lw"][k]),
             5e-5)
    for k in ("alw", "blw"):
        gate(f"{k} relmax", relmax(upd[k], upd_p[k]), 5e-5)
    flips = []
    for name, a, b in [*[(f"SolarState.{f}", getattr(sol, f),
                          getattr(sol_p, f)) for f in sol._fields],
                       *[(f"sw export {k}", upd["sw"][k], upd_p["sw"][k])
                         for k in upd["sw"]]]:
        gate(f"{name} relmax", relmax(a, b), 5e-4)
        flips.append((flipped_share(a, b), name))
    worst = max(flips)
    gate(f"flipped column share, worst ({worst[1]})", worst[0], 5e-3)
    dtdt, dtdt_p = upd["dtdt"], upd_p["dtdt"]
    heating_rate_gates(dtdt, dtdt_p, inp.ple, upd_p["sw"]["fsw"],
                       upd_p["lw"]["flw"], 5e-4, 5e-5)
    play = 0.5 * (inp.ple[:, 1:] + inp.ple[:, :-1])
    low = play > 1.0e4
    print(f"  heating_rates relmax {relmax(dtdt, dtdt_p):.3e}, below "
          f"100 hPa {relmax(dtdt[low], dtdt_p[low]):.3e} (reported)")

    for name, x in [*zip(sol._fields, sol), *zip(irr._fields, irr),
                    *upd["sw"].items(), *upd["lw"].items(), ("dtdt", dtdt)]:
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name} has non-finite values")
    if sol.flxn.shape != (ncol, NLEV + 1) or irr.olrb.shape != (ncol, 16) \
            or sol.flx_sfc_band_n.shape != (ncol, 14):
        raise AssertionError("state shapes are wrong")
    # net SW (normalized by the TOA insolation) never exceeds it
    net_max = float(sol.flxn.max())
    print(f"  SW net / TOA insolation: max {net_max:.4f}, surface min "
          f"{float(sol.flxn[:, -1].min()):.4f}")
    if not (net_max <= 1.0 + 1e-6 and float(sol.flxn[:, -1].min()) >= 0.0):
        raise AssertionError("SW net flux beyond the TOA insolation")
    olr = upd["lw"]["olr"]
    print(f"  OLR min/mean/max {float(olr.min()):.1f} / "
          f"{float(olr.mean()):.1f} / {float(olr.max()):.1f} W/m^2")
    if not (float(olr.min()) > 150.0 and float(olr.max()) < 350.0):
        raise AssertionError("OLR outside 150-350 W/m^2")
    hr = (dtdt * 86400.0)[low]
    print(f"  |SW+LW heating| below 100 hPa: max "
          f"{float(hr.abs().max()):.2f} K/day")
    if not float(hr.abs().max()) < 50.0:
        raise AssertionError("heating rate beyond 50 K/day")

    def wall(plain, n=5):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            refresh(plain)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    # plain, kernel, kernel, plain: compare within one call
    torch.cuda.reset_peak_memory_stats()
    t_plain = [wall(True)]
    t_kern = [wall(False), wall(False)]
    t_plain.append(wall(True))
    tk, tp = min(t_kern), min(t_plain)
    print(f"  radiation_refresh wall time (median of 5, better of 2 rounds):"
          f" kernels {tk * 1e3:.2f} ms ({ncol / tk:.0f} columns/s), plain "
          f"{tp * 1e3:.2f} ms ({ncol / tp:.0f} columns/s); rounds "
          f"{t_kern} / {t_plain}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches, dict(inp=inp, cfg=cfg, ict=ict, icb=icb, nlit=nlit,
                          ncld=ncld, mods=mods, refresh=refresh), calls


def profile_phase(torch, step, nwall=30, nprof=5):
    """--profile: where the time of the full-width refresh goes."""
    from torch.profiler import ProfilerActivity, profile

    from geosradiation_gridcomp_tpu_torch.driver import radiation as rad
    from geosradiation_gridcomp_tpu_torch.driver.astronomy import \
        mean_cos_zenith
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.sw import \
        SEED_ORDER_SW
    from geosradiation_gridcomp_tpu_torch.ops import mcica

    refresh = step["refresh"]
    inp, cfg, nlit = step["inp"], step["cfg"], step["nlit"]
    print(f"profile: radiation_refresh at {NCOL_SLICE} x {NLEV}:")
    times = []
    for _ in range(nwall):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refresh(False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    q = statistics.quantiles(times, n=4)
    print(f"  wall over {nwall}: median {statistics.median(times) * 1e3:.3f}"
          f" ms, quartiles {q[0] * 1e3:.3f} / {q[2] * 1e3:.3f}, min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(nprof):
            refresh(False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / nprof

    def on_device(e):
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    rows = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if on_device(e) and e.device_time_total > 0),
                  reverse=True)
    total = sum(r[0] for r in rows) / 1e3 / nprof
    print(f"  under the profiler: {wall * 1e3:.3f} ms per refresh, device "
          f"kernel time {total:.3f} ms in "
          f"{sum(r[1] for r in rows) / nprof:.0f} launches")
    for dt, count, key in rows[:25]:
        print(f"  {dt / 1e3 / nprof:8.3f} ms {count / nprof:7.1f}x  "
              f"{key[:100]}")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if on_device(e) and e.time_range.elapsed_us() > 0)
    busy, cur = 0, None
    for start, end in spans:
        if cur is None or start > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    busy += 0 if cur is None else cur[1] - cur[0]
    span = spans[-1][1] - spans[0][0] if spans else 0
    print(f"  device busy {busy / 1e3:.3f} of {span / 1e3:.3f} ms profiled "
          f"({100.0 * (1.0 - busy / max(span, 1)):.1f} % idle under the "
          f"profiler)")

    # K1 and K2 derive the subkeys and K2 the SW band optics on the card:
    # the refresh calls neither subcolumn_keys nor band_optics_coeffs_sw
    # (the plain twins do)
    found = off_kernel_path_calls(lambda: refresh(False))
    print(f"  calls of the plain key and band-optics functions in a "
          f"refresh: {found}")
    if any(found.values()):
        raise AssertionError(f"the refresh ran {found}")

    slr, lit = mean_cos_zenith(inp.lons, inp.lats, DOY, UTC,
                               cfg.solar_dt / 3600.0)
    zth = torch.where(lit > 0.0, slr / torch.clamp(lit, min=1e-6),
                      torch.zeros_like(slr))
    play = rad._common_derived(inp)[0]
    stages = dict(
        solar_refresh=lambda: rad.solar_refresh(
            inp, zth, DOY, cfg, step["ict"], step["icb"], nlit=nlit,
            ncld=step["ncld"], sw=step["mods"]["sw"]),
        irrad_refresh=lambda: rad.irrad_refresh(
            inp, DOY, cfg, step["ict"], step["icb"], lw=step["mods"]["lw"]),
        subcolumn_keys_lw_off_kernel_path=lambda: mcica.subcolumn_keys(play),
        subcolumn_keys_sw_off_kernel_path=lambda: mcica.subcolumn_keys(
            play[:nlit], SEED_ORDER_SW))
    for name, fn in stages.items():
        print(f"  {name} alone: {time_ms(torch, fn, 10):.3f} ms (CUDA "
              f"events, mean of 10)")


def off_kernel_path_calls(run):
    """Calls that run() makes of ops.mcica.subcolumn_keys and of
    cldprmc_sw.band_optics_coeffs_sw, wherever the port imported them."""
    import importlib
    names = ("subcolumn_keys", "band_optics_coeffs_sw")
    mods = [importlib.import_module(f"geosradiation_gridcomp_tpu_torch.{m}")
            for m in ("ops.mcica", "ops.mcica_cuda", "models.rrtmg.sw",
                      "models.rrtmg.lw", "models.rrtmg.cldprmc_sw")]
    found = dict.fromkeys(names, 0)
    saved = [(m, n, getattr(m, n)) for m in mods for n in names
             if hasattr(m, n)]

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            found[name] += 1
            return fn(*args, **kwargs)
        return wrapper
    try:
        for m, n, fn in saved:
            setattr(m, n, counted(n, fn))
        run()
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    return found


_CSRC = "geosradiation_gridcomp_tpu_torch/csrc/"
_REF = "geosradiation_gridcomp_tpu/"
# kernel -> (source, the TPU kernel it replaces, the path that must launch
# it: step, verify or profiling)
SOURCES = {
    "mcica_optics_lw": (_CSRC + "mcica_lw.cu",
                        _REF + "ops/mcica_pallas.py:367", "step"),
    "mcica_optics_sw": (_CSRC + "mcica_sw.cu",
                        _REF + "ops/mcica_pallas.py:588", "step"),
    "taumol_lw": (_CSRC + "taumol_lw.cu",
                  _REF + "models/rrtmg/taumol_lw_pallas.py:457", "step"),
    "rtrnmc": (_CSRC + "rtrnmc.cu",
               _REF + "models/rrtmg/rtrnmc_pallas.py:239", "step"),
    "taumol_sw": (_CSRC + "taumol_sw.cu",
                  _REF + "models/rrtmg/taumol_sw_pallas.py:246", "step"),
    "spcvmc": (_CSRC + "spcvmc.cu",
               _REF + "models/rrtmg/spcvmc_pallas.py:454", "step"),
    "mcica_subcols_raw": (_CSRC + "mcica_raw.cu",
                          _REF + "ops/mcica_pallas.py:483", "verify"),
    "ffill": (_CSRC + "ffill.cu",
              "tools/profiling/fused_mcica_check.py:56", "profiling"),
    "gather_rows": (_CSRC + "gather_micro.cu",
                    "tools/profiling/gather_micro.py:63", "profiling"),
    "gather_lanes": (_CSRC + "gather_micro.cu",
                     "tools/profiling/gather_micro.py:96", "profiling"),
    "taumol_lw_bisect": (_CSRC + "taumol_lw_bisect.cu",
                         "tools/profiling/taumol_lw_bisect.py:58",
                         "profiling"),
}


def require_launched(launches, path):
    """Raise unless every kernel of the path launched in its run."""
    for name, (_, _, p) in SOURCES.items():
        if p == path and launches.get(name, 0) < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{path} path")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile the full-width refresh")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test runs only "
                         "on a GPU")
    from geosradiation_gridcomp_tpu_torch.kernels import build
    from geosradiation_gridcomp_tpu_torch.tools.profiling import \
        kernel_resources
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    path = build.build()
    build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {path}")

    draw = kernel_resources.threefry_counts()
    print(f"one threefry draw: {sum(draw.values())} SASS instructions "
          f"{draw}, {1e12 * issue_seconds(draw, 1):.3f} ps on the card")
    dev = torch.device("cuda", 0)
    launches, step, calls = step_phase(torch, dev)
    results = step_kernel_phases(torch, dev, calls, draw)
    sync_free_phase(torch, calls)
    del calls
    results.update(raw_and_profiling_kernel_phases(torch, dev, draw))
    if args.profile:
        profile_phase(torch, step)
    paths = {"step": launches, "verify": verify_path(torch),
             "profiling": profiling_path(torch)}
    for path in ("verify", "profiling"):
        print(f"  kernel launches in the {path} path: {paths[path]}")
        require_launched(paths[path], path)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "geosradiation_gridcomp_tpu"))
    if loaded:
        raise AssertionError(f"the port loaded {loaded[:5]}")

    kernels = []
    for name, (source, replaces, path) in SOURCES.items():
        r = results[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            path=path, launches=paths[path][name],
            launches_per_refresh=paths[path][name] if path == "step"
            else 0, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
