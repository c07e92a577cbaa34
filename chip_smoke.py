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
   exactly equal; P2's gather_rows exactly equal in every case of its
   contract (gather_cuda.ROWS_CASES: ragged N, ng 14 and 5, a table off
   16 B, clamped indices, a 5000-row table, 1100 columns, the refresh's
   LW cloud tables), printing the template instance each ran; at the
   refresh's LW cloud-table gathers (absice3, absliq1 at 8192 x 72
   indices, kernel_ab.lw_cloud_gathers) beside tab[index]; P2's
   gather_rows and gather_lanes at the profiling tool's 8192 x 72 points
   exactly equal, gather_rows timed with each output kept alive for 4
   calls (kernel_ab.rotating: the writes then exceed the 50 MB L2) and,
   for comparison, dropped at once, beside the library calls tab[idx] and
   index_select (library_ms: the faster); P3's full variant equal to K3
   bit for bit and every variant within relmax 5e-4 of its twin in every
   band, at 1024 x 72. Every kernel's device time (torch.profiler,
   device_ms) beside its CUDA-event time;
4. verify path: the verification suite's entry point
   (tools/verify.py --quick, 512 x 72), every gate passing; K7 must
   launch there;
5. profiling path: the three profiling entry points (fused_mcica_check
   at 1024 columns, gather_micro at its default size, taumol_lw_bisect
   at 1024 x 72), each raising on a failed check; P1, both P2 kernels and
   P3 must launch there;
6. rats phase: the RATS diagnostics (the LW re-solved with each of the 8
   trace gases zeroed in turn, driver/diagnostics.py:rats_refresh) at
   8192 x 72 with the step's ict/icb, through the kernels: K1, K3 and K4
   must launch exactly 8 times each and nothing else; K3 within relmax
   5e-4 of its twin in every band on each gas's inputs (the zeroed gas
   drives taumol's specparm to its edges); every gas's RatsState within
   relmax 5e-5 of the plain twins on the card (the LW gate); rats_update's CO2 and CH4 TOA forcing, each column mean
   positive and CO2's above CH4's; the refresh's wall time (median of 5)
   and device time (CUDA events);
7. chou phase: radiation_refresh + radiation_update with the Chou-Suarez
   SW and LW schemes at 8192 x 72 on the card, where no CUDA kernel of
   the port may launch; every SolarState and IrradState field and every
   flux export within relmax 5e-5 of the same functions on the CPU on the
   first 256 columns, the heating rates in the reference's form
   (heating_rate_gates at those flux gates); SW net / TOA insolation in
   [0, 1] and OLR in 120-340 W/m^2; the wall time (median of 3) and the
   peak device memory;
8. rrtmgp phase: radiation_refresh + radiation_update with the RRTMGP SW
   and LW schemes through the RRTMG-reduced facade at 8192 x 72: K3, K4
   and K5 must launch exactly once each and nothing else (K5 on all
   8192 columns: the facade does not pack daylight); K3 and K5 within
   relmax 5e-4 of their twins in every band and K4 in every output, on
   the inputs this path gives them; every IrradState field and LW export
   within 5e-5 of plain=True on the card, every SolarState field and SW
   export within 5e-4 with at most 0.5 % of columns beyond 5e-5, the
   heating rates in the reference's form; SW net / TOA insolation in
   [0, 1] and OLR in 150-350 W/m^2; the clear-sky difference from the
   RRTMG step (flcn, flc), the wall time (median of 3) and CUDA-event
   time of the refresh, the plain refresh's wall, the McICA draws'
   time (_gen_max_ran_mask, SW and LW) and the peak device memory;
9. rrtmgp_native phase: the same through the native engine, on a
   synthetic 2-band coefficient set written to build/ (a numpy copy of
   the reference's tests/test_rrtmgp_engine.py:make_kdist), at 8192 x 72:
   no kernel may launch, olrb has the set's 2 bands, every state field
   and export within 5e-5 of the CPU on the first 256 columns (the
   grazing-sun columns, cos zenith under 1e-4, reported apart: there the
   reference's two mu0 floors make the normalized SW state follow the
   card's and the CPU's cosine itself), the
   heating rates in the reference's form, physics, wall time and peak
   memory;
10. driver phase: a RadiationClock (30 min heartbeat, hourly refresh) for
   4 heartbeats at 8192 x 72 with the kernels: validate_inputs and
   radiation_refresh + rats_refresh on the alarm, radiation_update +
   rats_update every heartbeat, check_finite on every new state and
   export; then the same run stopped after heartbeat 2, checkpointed
   (build/driver_checkpoint.npz) and restarted from
   load_checkpoint(device="cuda"): every export of the restarted run
   bitwise equal to the uninterrupted run's; the update's wall time per
   heartbeat;
11. satsim phase: cosp_simulator (SatsimConfig(): 50 subcolumns, every
   simulator, the 40-bin CloudSat stat grid) at 8192 points x 50
   subcolumns x 72 levels on a scene made from the realistic one
   (satsim_inputs), key 11: no kernel may launch; every group and key
   present, each value finite or one of the reference's fill values, the
   ranges the reference's satsim tests check; the same call on the first
   256 points on the card and on the CPU: frac_out, prec_frac and the
   MODIS phases identical, fill values in the same places, every other
   float within relmax 5e-5 (meantaucld in albedo space), the histogram
   counts compared and any flipped count reported; wall time (median of
   3), CUDA-event time, the radar alone and the peak device memory;
12. parallel phase: the step's refresh through shard_columns(
   column_mesh(), inp) + run_sharded at 8192 x 72, bitwise equal to the
   unsharded refresh, K1-K6 launched; in two shards on the one card,
   bitwise equal but for the McICA cover of dark columns (each shard's
   own packing bound, reported); pad_columns from 8197 to 8200 columns,
   the first 8197 equal to the unpadded refresh likewise; bench.py's
   staged workload (8 host batches of 4096 x 72, seeds 0-7) through
   run_steps_overlapped and through a serial put/get/step/synchronize
   loop: outputs bitwise equal, columns/s of both and their ratio, and a
   torch.profiler trace of the overlapped run (build/staged_trace.json):
   the streams of the host-to-device copies from pinned memory and of the
   kernels, and the share of the copies' time that overlapped a kernel
   of another stream.

Then it checks that neither jax nor any module of the reference package
geosradiation_gridcomp_tpu was loaded.

    python3 chip_smoke.py --profile

adds, after the step phase, where the time of the full-width refresh
goes: its wall time over 30 runs, the device time of each CUDA kernel,
the launches per refresh and the device's idle share (torch.profiler),
a check that the refresh calls neither ops.mcica.subcolumn_keys nor
band_optics_coeffs_sw (K1 and K2 derive the subkeys, K2 the SW band
optics, on the card), and the solar_refresh and irrad_refresh stages
alone, beside subcolumn_keys, now off the kernel path (CUDA events);
and the same device profile of the RATS refresh, the Chou refresh +
update, the RRTMGP facade refresh, the native RRTMGP refresh + update,
a heartbeat's radiation_update + rats_update and cosp_simulator.

Prints the card's name and power limit, a JSON line with each kernel's
launches (counted on the path named by its `path`: step, verify or
profiling; launches_per_refresh for the step kernels; launches_by_path
on every path that launched it, K1, K3 and K4 also on rats, K3, K4 and
K5 also on rrtmgp, K1-K6 also on driver and parallel), error,
times, bound and library time, and as its last line
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
            device_ms=kernel_device_ms(torch, name,
                                       lambda: fn(*args, **kw)),
            plain_ms=time_ms(torch, lambda: plain(*args, **kw), 3),
            bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
        print(f"  {results[name]['ms']:.4f} ms, device "
              f"{results[name]['device_ms']:.4f} ms (plain "
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


def kernel_device_ms(torch, name, fn):
    """Device time (ms) of kernel `name`'s CUDA function per call of fn
    (torch.profiler over 5 calls)."""
    from geosradiation_gridcomp_tpu_torch.tools.profiling.kernel_ab import \
        device_ms
    return device_ms(torch, fn, SOURCES[name][3])[0]


def p2_rows_phase(torch, dev, gen, timed, exact):
    """P2's gather_rows: every case of its contract (ROWS_CASES) exactly
    equal to the twin, with the template instance each ran; the refresh's
    LW cloud-table gathers beside tab[index]; then the timed run at the
    gather tool's 8192 x NLEV points, each call's output kept alive for
    LIVE calls (and, for comparison, dropped at once)."""
    from geosradiation_gridcomp_tpu_torch.ops.gather_cuda import (
        ROWS_CASES, gather_rows, gather_rows_plain, rows_vec)
    from geosradiation_gridcomp_tpu_torch.tools.profiling.kernel_ab import (
        LIVE, host_ms, lw_cloud_gathers, rotating)

    print("P2 gather_rows, the cases of its contract:")
    for case, (n, rows, ng, lo, hi, off) in ROWS_CASES.items():
        flat = torch.randn(rows * ng + off, device=dev, generator=gen)
        tab = flat[off:].view(rows, ng)
        idx = torch.randint(lo, hi, (n,), device=dev, generator=gen,
                            dtype=torch.int32)
        out = gather_rows(idx, tab)
        print(f"  {case}: {n} points, {rows} x {ng} table, indices "
              f"[{lo}, {hi}), instance float{rows_vec(tab, out)}")
        exact(f"gather_rows {case}", out, gather_rows_plain(idx, tab))

    print(f"P2 gather_rows at the refresh's LW cloud-table gathers "
          f"({NCOL_SLICE} x {NLEV} indices, outputs rotated over {LIVE}):")
    for name, (tab, index) in lw_cloud_gathers(torch, dev).items():
        idx = index.reshape(-1).int()
        out = gather_rows(idx, tab)
        exact(f"gather_rows {name}", out, tab[index.reshape(-1)])
        k = time_ms(torch, rotating(lambda: gather_rows(idx, tab)), 20)
        lib = time_ms(torch, rotating(lambda: tab[index]), 20)
        print(f"  {name} [{tab.shape[0]} x {tab.shape[1]}]: gather_rows "
              f"{k:.4f} ms (float{rows_vec(tab, out)}), tab[index] "
              f"{lib:.4f} ms, {lib / k:.1f}x")

    n, rows = 8192 * NLEV, 585
    tab = torch.randn(rows, 16, device=dev, generator=gen)
    idx = torch.randint(0, rows, (n,), device=dev, generator=gen,
                        dtype=torch.int32)
    out = gather_rows(idx, tab)
    print(f"P2 gather_rows at {n} points, {rows} x 16 table, instance "
          f"float{rows_vec(tab, out)}:")
    run = lambda: gather_rows(idx, tab)
    cached = time_ms(torch, run, 20)
    # the library: the faster of PyTorch's two calls for tab[idx]
    libs = {"tab[idx]": lambda: tab[idx],
            "index_select": lambda: torch.index_select(tab, 0, idx)}
    lib_ms = {k: time_ms(torch, rotating(f), 20) for k, f in libs.items()}
    host = host_ms(torch, rotating(run), 20, 3)
    print(f"  outputs dropped at once (cached): {cached:.4f} ms; the "
          f"host's time to enqueue a call {host:.4f} ms; library "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in lib_ms.items())
          + " (rotated)")
    timed("gather_rows", rotating(run), lambda: gather_rows_plain(idx, tab),
          exact("gather_rows", out, gather_rows_plain(idx, tab)),
          bound(nbytes(idx, tab, out)), n_plain=20,
          library_ms=min(lib_ms.values()))


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
        gather_lanes, gather_lanes_plain)
    from geosradiation_gridcomp_tpu_torch.ops.mcica_cuda import (
        mcica_subcols_raw, mcica_subcols_raw_plain)
    from geosradiation_gridcomp_tpu_torch.scene import example_inputs
    from geosradiation_gridcomp_tpu_torch.tools.profiling.taumol_lw_bisect \
        import lw_coefs

    ncol = NCOL_KERNEL
    results = {}

    def timed(name, fn, plain, err, bnd, n_plain=3, library_ms=None):
        r = results[name] = dict(
            max_abs_err=err, ms=time_ms(torch, fn, 20),
            device_ms=kernel_device_ms(torch, name, fn),
            plain_ms=time_ms(torch, plain, n_plain), bound_ms=bnd[0],
            bound_by=bnd[1], library_ms=library_ms)
        print(f"  {name}: {r['ms']:.4f} ms, device {r['device_ms']:.4f} ms "
              f"(plain {r['plain_ms']:.2f} ms), bound {bnd[0]:.4f} ms by "
              f"{bnd[1]}: {100 * bnd[0] / r['ms']:.0f} % of the card ms, "
              f"{100 * bnd[0] / max(r['device_ms'], 1e-9):.0f} % of the "
              f"device ms")

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

    p2_rows_phase(torch, dev, gen, timed, exact)
    n, rows = 8192 * NLEV, 585
    tab = torch.randn(rows, 16, device=dev, generator=gen)
    tabt = torch.nn.functional.pad(tab.T, (0, 640 - rows)).contiguous()
    idx = torch.randint(0, rows, (n,), device=dev, generator=gen,
                        dtype=torch.int32)
    idx2d = idx.reshape(-1, 128)
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


def synthetic_kdist():
    """A synthetic but structurally faithful native k-distribution (2
    bands, 16 g-points, 3 gases, one minor contributor) in the engine's
    dict form: a numpy copy of the reference's
    tests/test_rrtmgp_engine.py:make_kdist() (held equal to it by
    tests/test_torch_rrtmgp_engine.py), since no real RRTMGP coefficient
    file is in the repo."""
    import numpy as np

    nt, ne, npr, ngpt = 5, 9, 12, 16
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, nt)[:, None, None, None]
    e = np.linspace(0, 1, ne)[None, :, None, None]
    p = np.linspace(0, 1, npr + 1)[None, None, :, None]
    g = np.linspace(0, 1, ngpt)[None, None, None, :]
    kmajor = (1e-22 * np.exp(0.8 * t + 0.5 * e - 1.2 * p + g)
              ).astype(np.float32)
    vmr_ref = np.ones((2, 4, nt))
    vmr_ref[:, 1] = 8e-3     # h2o
    vmr_ref[:, 2] = 4e-4     # co2
    vmr_ref[:, 3] = 5e-6     # o3
    gpoint_flavor = np.zeros((2, ngpt), np.int64)
    gpoint_flavor[:, :8] = 1
    gpoint_flavor[:, 8:] = 2
    minor = dict(
        kminor=(1e-23 * (1.0 + rng.random((nt, ne, 8)))).astype(np.float32),
        gpt_limits=np.array([[1, 8]], np.int64),
        gas_idx=np.array([3], np.int64),
        scales_with_density=np.array([False]),
        scaling_gas=np.array([0], np.int64),
        scale_by_complement=np.array([False]))
    return dict(
        gas_names=np.array(["h2o", "co2", "o3"]), h2o_idx=np.int64(1),
        press_ref=np.geomspace(103000.0, 100.0, npr),
        press_ref_trop=np.float64(9948.0),
        temp_ref=np.linspace(160.0, 340.0, nt), vmr_ref=vmr_ref,
        flavor=np.array([[1, 2], [3, 0]], np.int64),
        gpoint_flavor=gpoint_flavor, kmajor=kmajor,
        band_lims_gpt=np.array([[1, 8], [9, 16]], np.int64),
        band_lims_wvn=np.array([[10.0, 500.0], [500.0, 2000.0]]),
        minor_lower=minor, minor_upper=None,
        totplnk=np.linspace(10.0, 60.0, 30)[:, None]
        * np.array([[0.6, 0.4]]),
        planck_frac=np.full((nt, ne, npr + 1, ngpt), 1.0 / 8.0, np.float32),
        temp_ref_planck=np.linspace(160.0, 340.0, 30),
        solar_src=np.full(ngpt, 85.0),
        rayl=(1e-25 * np.ones((2, nt, ne, ngpt))).astype(np.float32))


def save_kdist_npz(data, path):
    """The engine dict as an npz of the ingest schema (minor blocks as
    minor_{which}_{field} keys), as tools/rrtmgp_ingest.py writes it."""
    import numpy as np

    out = {}
    for k, v in data.items():
        if k in ("minor_lower", "minor_upper"):
            for kk, vv in (v or {}).items():
                out[f"{k}_{kk}"] = vv
        else:
            out[k] = v
    np.savez(path, **out)


def state_and_export_pairs(sol, irr, upd, ref):
    """(name, value, reference value) of every SolarState and IrradState
    field, flux export and ALW/BLW of a refresh + update against ref's."""
    sol_r, irr_r, upd_r = ref
    return [*((f"SolarState.{f}", getattr(sol, f), getattr(sol_r, f))
              for f in sol._fields),
            *((f"IrradState.{f}", getattr(irr, f), getattr(irr_r, f))
              for f in irr._fields),
            *((f"{g} export {k}", upd[g][k], upd_r[g][k])
              for g in ("sw", "lw") for k in upd_r[g]),
            *((k, upd[k], upd_r[k]) for k in ("alw", "blw"))]


def check_physical(torch, sol, irr, upd, olr_range, sw_cols=slice(None)):
    """Finite states and exports, SW net / TOA insolation in [0, 1] (on
    the columns sw_cols), OLR inside olr_range (W/m^2); prints them."""
    for name, x in [*zip(sol._fields, sol), *zip(irr._fields, irr),
                    *upd["sw"].items(), *upd["lw"].items()]:
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name} has non-finite values")
    flxn = sol.flxn[sw_cols]
    net_max, sfc_min = float(flxn.max()), float(flxn[:, -1].min())
    olr = upd["lw"]["olr"]
    print(f"  SW net / TOA insolation: max {net_max:.4f}, surface min "
          f"{sfc_min:.4f}; OLR min/mean/max {float(olr.min()):.1f} / "
          f"{float(olr.mean()):.1f} / {float(olr.max()):.1f} W/m^2")
    if not (net_max <= 1.0 + 1e-6 and sfc_min >= 0.0):
        raise AssertionError("SW net flux outside [0, 1] of the TOA "
                             "insolation")
    if not olr_range[0] < float(olr.min()) <= float(olr.max()) \
            < olr_range[1]:
        raise AssertionError(f"OLR outside {olr_range} W/m^2")


def walls(torch, fn, n):
    """Host-clock seconds of n calls of fn, each ended by a synchronize."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def rats_phase(torch, step, profile=False):
    """RATS at full width through rats_refresh, against the plain twins
    (with profile, where its time goes); returns the launches of the
    kernel run."""
    from geosradiation_gridcomp_tpu_torch.driver.diagnostics import (
        RATS_GASES, rats_refresh, rats_update)
    from geosradiation_gridcomp_tpu_torch.driver.radiation import \
        irrad_refresh
    from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
    from geosradiation_gridcomp_tpu_torch.models.rrtmg import lw as lwm
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw import (
        NGS_LW, taumol_lw)

    inp, cfg, ict, icb = step["inp"], step["cfg"], step["ict"], step["icb"]
    lw = step["mods"]["lw"]

    def refresh(plain=False):
        return rats_refresh(inp, DOY, cfg, ict, icb, lw=lw, plain=plain)

    print(f"rats: rats_refresh over {len(RATS_GASES)} gases at "
          f"{inp.t.shape[0]} x {NLEV}:")
    # K3's inputs of each solve, kept to hold K3 to its twin on them
    k3, k3_calls = lwm.taumol_lw_fast, []

    def k3_recorded(*args, **kwargs):
        k3_calls.append((args, kwargs))
        return k3(*args, **kwargs)
    lwm.taumol_lw_fast = k3_recorded
    try:
        torch.cuda.synchronize()
        LAUNCHES.clear()
        rats = refresh()
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    finally:
        lwm.taumol_lw_fast = k3
    print(f"  kernel launches in the rats path: {launches}")
    want = {k: len(RATS_GASES)
            for k in ("mcica_optics_lw", "taumol_lw", "rtrnmc")}
    if launches != want:
        raise AssertionError(f"rats path launched {launches}, not {want}")
    for gas, (args, kwargs) in zip(RATS_GASES, k3_calls):
        err = max(band_relmax(a, b, NGS_LW) for a, b in zip(
            k3(*args, **kwargs), taumol_lw(*args, **kwargs)))
        gate(f"{gas} K3 vs its twin, worst band", err, 5e-4)
    del k3_calls
    plain = refresh(plain=True)
    for g, gas in enumerate(RATS_GASES):
        err, field = max((relmax(getattr(rats, f)[g], getattr(plain, f)[g]),
                          f) for f in rats._fields)
        gate(f"{gas} RatsState relmax, worst ({field})", err, 5e-5)
    irr = irrad_refresh(inp, DOY, cfg, ict, icb, lw=lw)
    _, forcing = rats_update(rats, irr, inp.tsinst + 0.5)
    toa = {gas: forcing[RATS_GASES.index(gas), :, 0] for gas in ("CO2",
                                                                "CH4")}
    for gas, f in toa.items():
        print(f"  {gas} TOA forcing min/mean/max {float(f.min()):.4f} / "
              f"{float(f.mean()):.4f} / {float(f.max()):.4f} W/m^2")
    co2, ch4 = float(toa["CO2"].mean()), float(toa["CH4"].mean())
    if not co2 > ch4 > 0.0:
        raise AssertionError(f"TOA forcing means CO2 {co2}, CH4 {ch4}")
    print(f"  rats_refresh wall "
          f"{statistics.median(walls(torch, refresh, 5)) * 1e3:.3f} ms "
          f"(median of 5), {time_ms(torch, refresh, 5):.3f} ms by CUDA "
          f"events (mean of 5)")
    if profile:
        device_profile(torch, "RATS refresh", refresh, 3, top=8)
    return launches


def chou_phase(torch, dev, profile=False):
    """The Chou-Suarez schemes at full width on the card, against the
    same functions on the CPU on the first 256 columns (with profile,
    where their time goes)."""
    from geosradiation_gridcomp_tpu_torch.config import (RadiationConfig,
                                                         Scheme)
    from geosradiation_gridcomp_tpu_torch.driver.radiation import \
        AtmosInputs
    from geosradiation_gridcomp_tpu_torch.driver.step import (
        radiation_refresh, radiation_update)
    from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
    from geosradiation_gridcomp_tpu_torch.scene import example_inputs

    cfg = RadiationConfig(sw_scheme=Scheme.CHOU, lw_scheme=Scheme.CHOU)
    inp = example_inputs(NCOL_SLICE, NLEV, seed=SEED, device=dev)
    ple0 = inp.ple[0].cpu().numpy()
    ict, icb = cfg.superlayer_indices(0.5 * (ple0[1:] + ple0[:-1]))

    def run(x):
        sol, irr = radiation_refresh(x, DOY, UTC, config=cfg, ict=ict,
                                     icb=icb)
        return sol, irr, radiation_update(sol, irr, x.tsinst + 0.5, x.lons,
                                          x.lats, x.ple, DOY, UTC + 0.25,
                                          config=cfg)

    print(f"chou: Chou-Suarez radiation_refresh + radiation_update at "
          f"{NCOL_SLICE} x {NLEV}, ict={ict} icb={icb}:")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    sol, irr, upd = run(inp)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if LAUNCHES:
        raise AssertionError(f"the Chou path launched {dict(LAUNCHES)}")
    n = 256
    sol_c, irr_c, upd_c = run(AtmosInputs(*(x[:n].cpu() for x in inp)))
    pairs = state_and_export_pairs(sol, irr, upd, (sol_c, irr_c, upd_c))
    err, name = max((relmax(a[:n].cpu(), b), name) for name, a, b in pairs)
    gate(f"card vs CPU relmax, worst of {len(pairs)} ({name})", err, 5e-5)
    # the heating rates divide flux differences by dp, a few Pa near the
    # model top: gated in the reference's form, as in the step phase
    heating_rate_gates(upd["dtdt"][:n].cpu(), upd_c["dtdt"],
                       inp.ple[:n].cpu(), upd_c["sw"]["fsw"],
                       upd_c["lw"]["flw"], 5e-5, 5e-5)
    check_physical(torch, sol, irr, upd, (120.0, 340.0))
    t = statistics.median(walls(torch, lambda: run(inp), 3))
    print(f"  refresh + update wall {t * 1e3:.1f} ms (median of 3, "
          f"{NCOL_SLICE / t:.0f} columns/s); peak device memory "
          f"{peak / 2**20:.1f} MiB")
    if profile:
        device_profile(torch, "Chou refresh + update", lambda: run(inp), 1,
                       top=10)


def rrtmgp_phase(torch, step, profile=False):
    """The RRTMGP facade at full width through radiation_refresh +
    radiation_update: K3, K4 and K5 once each per refresh on the inputs
    this path gives them, held to their twins; the refresh against
    plain=True on the card; physics; times and peak memory (with profile,
    where its time goes). Returns the launches of the kernel run."""
    from geosradiation_gridcomp_tpu_torch.config import (RadiationConfig,
                                                         Scheme)
    from geosradiation_gridcomp_tpu_torch.driver.astronomy import \
        mean_cos_zenith
    from geosradiation_gridcomp_tpu_torch.driver.radiation import (
        _common_derived)
    from geosradiation_gridcomp_tpu_torch.driver.step import (
        radiation_refresh, radiation_update)
    from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.lw import mid_heights
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.rtrnmc import rtrnmc
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw import (
        NGS_LW, taumol_lw)
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_sw import (
        NGS_SW, taumol_sw)
    from geosradiation_gridcomp_tpu_torch.models.rrtmgp import kdist, rte
    from geosradiation_gridcomp_tpu_torch.models.rrtmgp import scheme

    inp, ict, icb, mods = step["inp"], step["ict"], step["icb"], step["mods"]
    cfg = RadiationConfig(sw_scheme=Scheme.RRTMGP, lw_scheme=Scheme.RRTMGP)

    def refresh(plain=False):
        return radiation_refresh(inp, DOY, UTC, config=cfg, ict=ict,
                                 icb=icb, plain=plain, **mods)

    def run(plain):
        sol, irr = refresh(plain)
        return sol, irr, radiation_update(sol, irr, inp.tsinst + 0.5,
                                          inp.lons, inp.lats, inp.ple, DOY,
                                          UTC + 0.25, config=cfg)

    print(f"rrtmgp: RRTMGP facade radiation_refresh + radiation_update at "
          f"{inp.t.shape[0]} x {NLEV}:")
    # each kernel's inputs on this path, kept to hold it to its twin
    wrapped = {"taumol_lw": (kdist, "taumol_lw_fast"),
               "taumol_sw": (kdist, "taumol_sw_fast"),
               "rtrnmc": (rte, "rtrnmc_fast")}
    saved = {k: getattr(m, a) for k, (m, a) in wrapped.items()}
    calls = {}

    def recorder(name):
        def wrapper(*args, **kwargs):
            calls.setdefault(name, (args, kwargs))
            return saved[name](*args, **kwargs)
        return wrapper
    try:
        for k, (m, a) in wrapped.items():
            setattr(m, a, recorder(k))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        sol, irr, upd = run(plain=False)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    finally:
        for k, (m, a) in wrapped.items():
            setattr(m, a, saved[k])
    print(f"  kernel launches in the rrtmgp path: {launches}")
    want = dict.fromkeys(wrapped, 1)
    if launches != want:
        raise AssertionError(f"rrtmgp path launched {launches}, not {want}")

    args, kw = calls["taumol_lw"]
    print(f"  K3 on {tuple(args[0].jp.shape)}, K5 on "
          f"{tuple(calls['taumol_sw'][0][0].jp.shape)}, K4 on "
          f"{tuple(calls['rtrnmc'][0][1].shape)}")
    for name, x, y in zip(("taug", "pfracs"), saved["taumol_lw"](*args, **kw),
                          taumol_lw(*args, **kw)):
        gate(f"K3 {name} vs its twin, worst band", band_relmax(x, y, NGS_LW),
             5e-4)
    args, kw = calls["taumol_sw"]
    for name, x, y in zip(("taug", "taur"), saved["taumol_sw"](*args, **kw),
                          taumol_sw(*args, **kw)):
        gate(f"K5 {name} vs its twin, worst band", band_relmax(x, y, NGS_SW),
             5e-4)
    args, kw = calls["rtrnmc"]
    a, b = saved["rtrnmc"](*args, **kw), rtrnmc(*args, **kw)
    err, name = max((relmax(a[k], b[k]), k) for k in b)
    gate(f"K4 vs its twin, worst ({name})", err, 5e-4)
    del a, b
    ms = {k: time_ms(torch, lambda: saved[k](*calls[k][0], **calls[k][1]),
                     20) for k in saved}
    print(f"  on this path's inputs (CUDA events, mean of 20): K3 "
          f"{ms['taumol_lw']:.4f}, K4 {ms['rtrnmc']:.4f}, K5 "
          f"{ms['taumol_sw']:.4f} ms")
    del calls, args, kw

    ref = run(plain=True)
    flips = []
    for name, a, b in state_and_export_pairs(sol, irr, upd, ref):
        lw = name.startswith(("IrradState", "lw ")) or name in ("alw", "blw")
        gate(f"{name} relmax", relmax(a, b), 5e-5 if lw else 5e-4)
        if not lw:
            flips.append((flipped_share(a, b), name))
    worst = max(flips)
    gate(f"flipped column share, worst ({worst[1]})", worst[0], 5e-3)
    heating_rate_gates(upd["dtdt"], ref[2]["dtdt"], inp.ple,
                       ref[2]["sw"]["fsw"], ref[2]["lw"]["flw"], 5e-4, 5e-5)
    check_physical(torch, sol, irr, upd, (150.0, 350.0))
    del ref

    # the clear sky against the RRTMG step (reported); spcvmc floors mu0
    # at 1e-4, rte_sw at 1e-6, so grazing-sun columns are also shown apart
    sol_g, irr_g = step["refresh"](False)
    slr, lit = mean_cos_zenith(inp.lons, inp.lats, DOY, UTC,
                               cfg.solar_dt / 3600.0)
    cosz = torch.where(lit > 0.0, slr / torch.clamp(lit, min=1e-6),
                       torch.zeros_like(slr))
    sun = cosz >= 1e-4
    print(f"  clear sky against the RRTMG step: flcn max |diff| "
          f"{max_abs(sol.flcn[sun], sol_g.flcn[sun]):.4e} of the TOA "
          f"insolation where cos zenith >= 1e-4 ("
          f"{max_abs(sol.flcn, sol_g.flcn):.4e} over all columns), flc max "
          f"|diff| {max_abs(irr.flc, irr_g.flc):.4f} W/m^2")
    del sol_g, irr_g

    t_kern = walls(torch, refresh, 3)
    t_plain = walls(torch, lambda: refresh(True), 1)
    play = _common_derived(inp)[0]
    zm = mid_heights(play, inp.t, inp.ple[..., -1])
    draws = {ng: time_ms(torch, lambda: scheme._gen_max_ran_mask(
        play, zm, inp.lats, DOY, inp.fcld, ng, mods["lw"].zcw_cols(1)), 2)
        for ng in (112, 140)}
    print(f"  radiation_refresh wall {statistics.median(t_kern) * 1e3:.1f} "
          f"ms (median of 3; {[round(t * 1e3, 1) for t in t_kern]}), "
          f"{time_ms(torch, refresh, 3):.1f} ms by CUDA events (mean of 3); "
          f"plain {t_plain[0] * 1e3:.1f} ms; the McICA draws "
          f"(_gen_max_ran_mask) SW {draws[112]:.1f} + LW {draws[140]:.1f} "
          f"ms by CUDA events; peak device memory {peak / 2**20:.1f} MiB")
    if profile:
        device_profile(torch, "RRTMGP refresh", refresh, 1, top=12)
    return launches


def rrtmgp_native_phase(torch, step, profile=False):
    """RRTMGP through the native engine (an ingested coefficient set: the
    synthetic one, written to build/) at full width on the card, where no
    kernel may launch, against the same functions on the CPU on the first
    256 columns (with profile, where its time goes)."""
    import os

    from geosradiation_gridcomp_tpu_torch.config import (RadiationConfig,
                                                         Scheme)
    from geosradiation_gridcomp_tpu_torch.driver.astronomy import \
        mean_cos_zenith
    from geosradiation_gridcomp_tpu_torch.driver.radiation import \
        AtmosInputs
    from geosradiation_gridcomp_tpu_torch.driver.step import (
        radiation_refresh, radiation_update)
    from geosradiation_gridcomp_tpu_torch.kernels.build import (BUILD_DIR,
                                                                LAUNCHES)
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.lw import RRTMGLW
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.sw import RRTMGSW

    inp, ict, icb, mods = step["inp"], step["ict"], step["icb"], step["mods"]
    paths = [os.path.join(os.path.dirname(BUILD_DIR),
                          f"rrtmgp_kdist_{b}.npz") for b in ("lw", "sw")]
    os.makedirs(os.path.dirname(BUILD_DIR), exist_ok=True)
    for p in paths:
        save_kdist_npz(synthetic_kdist(), p)
    cfg = RadiationConfig(sw_scheme=Scheme.RRTMGP, lw_scheme=Scheme.RRTMGP,
                          rrtmgp_kdist_lw=paths[0], rrtmgp_kdist_sw=paths[1],
                          outputs=frozenset({"olrb"}))

    def run(x, m):
        sol, irr = radiation_refresh(x, DOY, UTC, config=cfg, ict=ict,
                                     icb=icb, **m)
        return sol, irr, radiation_update(sol, irr, x.tsinst + 0.5, x.lons,
                                          x.lats, x.ple, DOY, UTC + 0.25,
                                          config=cfg)

    print(f"rrtmgp_native: RRTMGP native engine (synthetic 2-band set, "
          f"{paths[0]}) radiation_refresh + radiation_update at "
          f"{inp.t.shape[0]} x {NLEV}:")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    sol, irr, upd = run(inp, mods)
    torch.cuda.synchronize()
    launches, peak = dict(LAUNCHES), torch.cuda.max_memory_allocated()
    print(f"  kernel launches in the rrtmgp_native path: {launches}")
    if launches:
        raise AssertionError(f"the native path launched {launches}")
    if tuple(irr.olrb.shape) != (inp.t.shape[0], 2):
        raise AssertionError(f"olrb has shape {tuple(irr.olrb.shape)}, not "
                             f"({inp.t.shape[0]}, 2)")
    n = 256
    head = AtmosInputs(*(x[:n].cpu() for x in inp))
    cpu = run(head, dict(sw=RRTMGSW.from_reference_tables("cpu"),
                         lw=RRTMGLW.from_reference_tables("cpu")))
    pairs = state_and_export_pairs(sol, irr, upd, cpu)
    # where the refresh's sun grazes the horizon (0 < cos zenith < 1e-4)
    # rte_sw_native floors mu0 at 1e-4 while the driver normalizes by the
    # cosine itself (the reference's two floors), so the normalized SW
    # state there is (1e-4 / cos) times the insolation fraction and takes
    # on the card-vs-CPU difference of the cosine itself: held apart
    slr, lit = mean_cos_zenith(inp.lons, inp.lats, DOY, UTC,
                               cfg.solar_dt / 3600.0)
    cosz = torch.where(lit > 0.0, slr / torch.clamp(lit, min=1e-6),
                       torch.zeros_like(slr))
    grazing_all = (cosz > 0.0) & (cosz < 1e-4)
    grazing = grazing_all[:n].cpu()
    err, name = max((relmax(a[:n].cpu()[~grazing], b[~grazing]), name)
                    for name, a, b in pairs)
    gate(f"card vs CPU relmax, worst of {len(pairs)} ({name})", err, 5e-5)
    if bool(grazing.any()):
        err, name = max((relmax(a[:n].cpu()[grazing], b[grazing]), name)
                        for name, a, b in pairs)
        print(f"  the {int(grazing.sum())} grazing-sun columns apart: card vs "
              f"CPU relmax {err:.3e} ({name}; reported)")
    heating_rate_gates(upd["dtdt"][:n].cpu(), cpu[2]["dtdt"],
                       inp.ple[:n].cpu(), cpu[2]["sw"]["fsw"],
                       cpu[2]["lw"]["flw"], 5e-5, 5e-5)
    # the synthetic set's Planck table (10-60 W/m^2 a band) gives ~30;
    # at grazing sun the normalized SW exceeds 1 by the two floors' ratio
    if bool(grazing_all.any()):
        print(f"  {int(grazing_all.sum())} grazing-sun columns of "
              f"{inp.t.shape[0]}, SW net / TOA insolation max "
              f"{float(sol.flxn[grazing_all].max()):.4f} there (reported)")
    check_physical(torch, sol, irr, upd, (10.0, 70.0), ~grazing_all)
    t = walls(torch, lambda: run(inp, mods), 3)
    print(f"  refresh + update wall {statistics.median(t) * 1e3:.1f} ms "
          f"(median of 3); peak device memory {peak / 2**20:.1f} MiB")
    if profile:
        device_profile(torch, "native RRTMGP refresh + update",
                       lambda: run(inp, mods), 1, top=10)
    return launches


def driver_phase(torch, step, profile=False):
    """The clock-driven model loop at full width with the kernels, then
    the same run restarted from a checkpoint after heartbeat 2 (with
    profile, where a heartbeat's update spends its time); returns the
    launches of the uninterrupted run."""
    import os

    from geosradiation_gridcomp_tpu_torch.driver.checkpoint import (
        load_checkpoint, save_checkpoint)
    from geosradiation_gridcomp_tpu_torch.driver.clock import RadiationClock
    from geosradiation_gridcomp_tpu_torch.driver.diagnostics import (
        rats_refresh, rats_update)
    from geosradiation_gridcomp_tpu_torch.driver.step import (
        radiation_refresh, radiation_update, sw_partition_bounds)
    from geosradiation_gridcomp_tpu_torch.driver.validate import (
        check_finite, validate_inputs)
    from geosradiation_gridcomp_tpu_torch.kernels.build import BUILD_DIR, \
        LAUNCHES

    inp, cfg, ict, icb = step["inp"], step["cfg"], step["ict"], step["icb"]
    mods = step["mods"]

    def refresh(clk):
        validate_inputs(inp)
        nlit, ncld = sw_partition_bounds(inp.lons, inp.lats, inp.fcld,
                                         clk.doy, clk.utc_hours, cfg)
        sol, irr = radiation_refresh(inp, clk.doy, clk.utc_hours, config=cfg,
                                     ict=ict, icb=icb, sw_nlit=nlit,
                                     sw_ncld=ncld, **mods)
        rats = rats_refresh(inp, clk.doy, cfg, ict, icb, lw=mods["lw"])
        for name, st in (("SolarState", sol), ("IrradState", irr),
                         ("RatsState", rats)):
            check_finite(st, name)
        return sol, irr, rats

    def update(states, doy, utc, ts):
        sol, irr, rats = states
        out = radiation_update(sol, irr, ts, inp.lons, inp.lats, inp.ple,
                               doy, utc, config=cfg)
        out["rats"] = dict(zip(("flx_rat", "forcing"),
                               rats_update(rats, irr, ts)))
        return out

    def heartbeats(clk, states, n, walls):
        outs = []
        for _ in range(n):
            for act in clk.tick():
                if act == "refresh":
                    states = refresh(clk)
                    continue
                ts = inp.tsinst + 0.25 * clk.time_s / clk.run_dt
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = update(states, clk.doy, clk.utc_hours, ts)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                outs.append(check_finite(out, "exports"))
        return states, outs

    def start():
        clk = RadiationClock(run_dt=1800.0, solar_dt=3600.0, start_doy=DOY,
                             start_utc_hours=UTC)
        return clk, refresh(clk)

    print(f"driver: RadiationClock(run_dt=1800, solar_dt=3600), 4 "
          f"heartbeats at {inp.t.shape[0]} x {NLEV}, then restarted from a "
          f"checkpoint after heartbeat 2:")
    walls = []
    torch.cuda.synchronize()
    LAUNCHES.clear()
    clk, states = start()
    _, ref = heartbeats(clk, states, 4, walls)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"  kernel launches in the driver path: {launches}")
    require_launched(launches, "step")

    clk, states = start()
    states, outs = heartbeats(clk, states, 2, [])
    path = os.path.join(os.path.dirname(BUILD_DIR), "driver_checkpoint.npz")
    save_checkpoint(path, solar=states[0], irrad=states[1], rats=states[2],
                    clock=clk)
    ck = load_checkpoint(path, device="cuda")
    if ck["irrad"].flx.device != inp.t.device:
        raise AssertionError("load_checkpoint did not put the state on the "
                             "card")
    outs += heartbeats(ck["clock"], (ck["solar"], ck["irrad"], ck["rats"]),
                       2, [])[1]
    flat = [(f"heartbeat {i + 1} {g}/{k}", a[g][k], b[g][k])
            for i, (a, b) in enumerate(zip(outs, ref))
            for g in ("sw", "lw", "rats") for k in b[g]]
    flat += [(f"heartbeat {i + 1} {k}", a[k], b[k])
             for i, (a, b) in enumerate(zip(outs, ref))
             for k in ("dtdt", "alw", "blw")]
    bad = [name for name, a, b in flat if not torch.equal(a, b)]
    gate(f"restarted vs uninterrupted exports not bitwise equal (of "
         f"{len(flat)})", len(bad), 0)
    print(f"  radiation_update + rats_update wall per heartbeat: "
          f"{', '.join(f'{w * 1e3:.3f}' for w in walls)} ms")
    if profile:
        device_profile(torch, "heartbeat update",
                       lambda: update(states, DOY, UTC, inp.tsinst), 5,
                       top=10)
    return launches


def satsim_inputs(torch, ncol, dev):
    """The satellite simulators' inputs from the realistic scene
    (scene.example_inputs, seed SEED): edge heights by hypsometric
    integration of ple and t from the surface; 2e-5 kg/kg rain from the
    top of a column's low deck (sigma 0.78-0.92, cloudy) to the surface
    and 1e-5 snow from the top of its mid deck (0.42-0.58), as the
    reference's cosp test puts rain below its cloud
    (tests/test_satsim_cosp.py:38); no graupel; the scene's radii in
    metres, graupel's 150 um; mcosz the mean cosine of the zenith over
    the refresh interval at doy DOY, UTC; land on the second half of the
    points."""
    from geosradiation_gridcomp_tpu_torch.config import RadiationConfig
    from geosradiation_gridcomp_tpu_torch.constants import AMD, GRAV, RGAS
    from geosradiation_gridcomp_tpu_torch.driver.astronomy import \
        mean_cos_zenith
    from geosradiation_gridcomp_tpu_torch.satsim import SatsimInputs
    from geosradiation_gridcomp_tpu_torch.scene import example_inputs

    inp = example_inputs(ncol, NLEV, seed=SEED, device=dev)
    ple, t = inp.ple, inp.t
    dz = (RGAS * 1000.0 / AMD / GRAV) * t * torch.log(ple[:, 1:]
                                                      / ple[:, :-1])
    zle = torch.cat([dz.flip(-1).cumsum(-1).flip(-1),
                     torch.zeros_like(dz[:, :1])], dim=-1)
    sigma = 0.5 * (ple[:, 1:] + ple[:, :-1]) / ple[:, -1:]
    lev = torch.arange(NLEV, device=dev)

    def below_deck(lo, hi, q):
        deck = (sigma > lo) & (sigma < hi) & (inp.fcld > 0.0)
        top = torch.argmax(deck.to(torch.int8), dim=1)
        return torch.where(deck.any(dim=1)[:, None] & (lev >= top[:, None]),
                           q, 0.0)
    qr = below_deck(0.78, 0.92, 2e-5)
    mcosz = mean_cos_zenith(inp.lons, inp.lats, DOY, UTC,
                            RadiationConfig().solar_dt / 3600.0)[0]
    return SatsimInputs(
        ple=ple, zle=zle, t=t, qv=inp.qv, fcld=inp.fcld, qi=inp.qi,
        ql=inp.ql, qr=qr, qs=below_deck(0.42, 0.58, 1e-5),
        qg=torch.zeros_like(qr), ri=inp.ri * 1e-6, rl=inp.rl * 1e-6,
        rr=inp.rr * 1e-6, rs=inp.rs * 1e-6, rg=torch.full_like(qr, 150e-6),
        ts=inp.ts, mcosz=mcosz,
        frland=(torch.arange(ncol, device=dev) >= ncol // 2).to(t.dtype))


# the reference's fill values (R_UNDEF, MISSING, UNDEF and UNDEF - 1;
# MISSING_DBZ; MODIS RE_FILL in m; R_GROUND) and the satsim fields that are
# a count of subcolumns over ncol
SATSIM_FILLS = (-1.0e30, -999.0, -999.0e-6, -1.0e20)
SATSIM_COUNTS = ("fq_isccp", "totalcldarea", "fq_misr", "cldarea",
                 "tau_vs_ctp", "cf_total", "cf_water", "cf_ice", "cf_high",
                 "cf_mid", "cf_low", "cfad_sr", "cfad_dbze",
                 "lidar_only_freq_cloud", "radar_lidar_tcc")


def satsim_fill(torch, x):
    fills = torch.tensor(SATSIM_FILLS, dtype=x.dtype, device=x.device)
    return torch.isin(x, fills) | (x.abs() >= 1e29)


def satsim_leaves(out, prefix=""):
    """(group/key, tensor) of every output of cosp_simulator."""
    for k, v in out.items():
        if isinstance(v, dict):
            yield from satsim_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def satsim_checks(torch, out, cfg, npnt):
    """Every group and key present; each value finite or one of the
    reference's fill values; the ranges the reference's tests check
    (tests/test_satsim_*.py)."""
    want = {"frac_out", "isccp", "misr", "modis", "lidar", "radar"}
    if set(out) != want:
        raise AssertionError(f"groups {sorted(out)}, not {sorted(want)}")
    nkeys = dict(isccp=9, misr=5, modis=19, lidar=9, radar=7)
    for g, n in nkeys.items():
        if len(out[g]) != n:
            raise AssertionError(f"{g} has keys {sorted(out[g])}")
    for name, x in satsim_leaves(out):
        if x.is_floating_point() and not bool(
                (torch.isfinite(x) | satsim_fill(torch, x)).all()):
            raise AssertionError(f"{name} has non-finite values")
    f = out["frac_out"]
    if tuple(f.shape) != (npnt, cfg.ncolumns, NLEV) or f.dtype != \
            torch.int8 or not bool(((f >= 0) & (f <= 2)).all()):
        raise AssertionError("frac_out is not int8 0/1/2 of [np, ncol, nlev]")

    def within(name, x, lo, hi, fill=True):
        v = x[~satsim_fill(torch, x)] if fill else x
        bad = int(((v < lo) | (v > hi)).sum())
        if bad:
            raise AssertionError(f"{name}: {bad} values outside "
                                 f"[{lo}, {hi}]")
        return v
    i, m, md, li, r = (out[g] for g in ("isccp", "misr", "modis", "lidar",
                                        "radar"))
    within("isccp totalcldarea", i["totalcldarea"], 0.0, 1.0)
    within("isccp fq_isccp sums", i["fq_isccp"].sum((1, 2))[
        i["totalcldarea"] >= 0.0], 0.0, 1.0 + 1e-5, fill=False)
    within("isccp meanptop (mb)", i["meanptop"], 0.0, 1100.0)
    within("isccp meantb, meantbclr (K)",
           torch.cat([i["meantb"], i["meantbclr"]]), 150.0, 350.0)
    within("misr cldarea", m["cldarea"], 0.0, 1.0)
    within("misr fq_misr sums", m["fq_misr"].sum((1, 2))[
        m["cldarea"] >= 0.0], 0.0, 1.0 + 1e-5, fill=False)
    for k in ("cf_total", "cf_water", "cf_ice", "cf_high", "cf_mid",
              "cf_low"):
        within(f"modis {k}", md[k], 0.0, 1.0)
    if not bool((md["cf_water"] + md["cf_ice"]
                 <= md["cf_total"] + 1e-6).all()):
        raise AssertionError("MODIS water + ice cloud beyond the total")
    within("modis l2 phase", md["l2"]["phase"], 0, 3, fill=False)
    within("lidar lidarcld, cldlayer",
           torch.cat([li["lidarcld"].flatten(), li["cldlayer"].flatten()]),
           0.0, 1.0)
    within("lidar cfad_sr sums", li["cfad_sr"].sum(1), 0.0, 1.0 + 1e-5,
           fill=False)
    within("radar cfad_dbze sums", r["cfad_dbze"].sum(1), 0.0, 1.0 + 1e-5,
           fill=False)
    within("radar lidar-only cloud, tcc",
           torch.cat([r["lidar_only_freq_cloud"].flatten(),
                      r["radar_lidar_tcc"]]), 0.0, 1.0)
    within("radar dbze (dBZe)", r["dbze"], -150.0, 80.0)
    lit = out["isccp"]["totalcldarea"] >= 0.0
    total = li["cldlayer"][:, 3]
    print(f"  {int(lit.sum())} sunlit points; ISCCP cloud area mean "
          f"{float(i['totalcldarea'][lit].mean()):.3f}, MODIS cf_total "
          f"{float(md['cf_total'][lit].mean()):.3f}, MISR cloud area "
          f"{float(m['cldarea'][lit].mean()):.3f}; lidar total cloud "
          f"{float(total[total >= 0.0].mean()):.3f}"
          f"; radar echoes above -30 dBZe in "
          f"{float((r['dbze'] > -30.0).double().mean()) * 100:.2f} % of "
          f"the subcolumn cells")


def satsim_compare(torch, card, cpu, ncol):
    """cosp_simulator on the card against the CPU, gated group by group:
    integers exact; fill values in the same places; the other floats
    within 5e-5 relmax (meantaucld in albedo space: its map from the mean
    albedo a, (6.82 / (1/a - 1))^(1/0.895), amplifies a's rounding by
    1 / (0.895 (1 - a)), over 600 at the thickest points); the count
    fields as counts, any flipped count reported with its share. Returns
    (flipped counts, counts)."""
    pairs = dict(satsim_leaves(cpu))
    groups = {}
    flips, total = 0, 0
    for name, a in satsim_leaves(card):
        g = groups.setdefault(name.split("/")[0],
                              dict(ints=0, fills=0, err=(0.0, "")))
        a, b = a.cpu(), pairs[name]
        if not b.is_floating_point():
            g["ints"] += int((a != b).sum())
            continue
        fa, fb = satsim_fill(torch, a), satsim_fill(torch, b)
        g["fills"] += int((fa != fb).sum())
        a, b = a[~fb], b[~fb]
        if name.rsplit("/", 1)[-1] in SATSIM_COUNTS:
            ca, cb = torch.round(a * ncol), torch.round(b * ncol)
            flips += int((ca != cb).sum())
            total += int(cb.sum())
            continue
        if name.endswith("meantaucld"):
            print(f"  {name} relmax {relmax(a, b):.3e} (reported; gated in "
                  f"albedo space)")
            a, b = [x.double() ** 0.895 / (x.double() ** 0.895 + 6.82)
                    for x in (a, b)]
        if b.numel():
            g["err"] = max(g["err"], (relmax(a, b), name))
    for k, g in groups.items():
        gate(f"{k}: integer mismatches", g["ints"], 0)
        gate(f"{k}: fill-value mismatches", g["fills"], 0)
        gate(f"{k}: relmax, worst ({g['err'][1]})", g["err"][0], 5e-5)
    print(f"  flipped histogram counts {flips} of {total} "
          f"({flips / max(total, 1):.2e}; reported)")
    return flips, total


def satsim_phase(torch, dev, profile=False):
    """The COSP satellite simulators at full width on the card (no
    kernel), against the same call on the CPU on 256 points; times,
    peak memory and the radar's share (with profile, where the time
    goes)."""
    from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
    from geosradiation_gridcomp_tpu_torch.ops import threefry
    from geosradiation_gridcomp_tpu_torch.satsim import (SatsimConfig,
                                                         SatsimInputs,
                                                         cosp, prec_scops)

    cfg = SatsimConfig()
    inp = satsim_inputs(torch, NCOL_SLICE, dev)
    key = threefry.key(11, device=dev)
    print(f"satsim: cosp_simulator (SatsimConfig(): {cfg.ncolumns} "
          f"subcolumns, every simulator, the {cfg.nlr}-bin stat grid) at "
          f"{NCOL_SLICE} points x {NLEV} levels, key 11:")
    # the radar's inputs, kept to time it alone
    qb, qb_calls = cosp.quickbeam_simulator, []

    def qb_recorded(*args, **kwargs):
        qb_calls.append((args, kwargs))
        return qb(*args, **kwargs)
    cosp.quickbeam_simulator = qb_recorded
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out = cosp.cosp_simulator(key, inp, cfg)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        launches, peak = dict(LAUNCHES), torch.cuda.max_memory_allocated()
    finally:
        cosp.quickbeam_simulator = qb
    print(f"  kernel launches in the satsim path: {launches}")
    if launches:
        raise AssertionError(f"the satsim path launched {launches}")
    satsim_checks(torch, out, cfg, NCOL_SLICE)
    del out

    n = 256
    head = SatsimInputs(*(x[:n] for x in inp))
    print(f"  card vs CPU on the first {n} points (their own call, key 11):")
    card = cosp.cosp_simulator(key, head, cfg)
    cpu_in = SatsimInputs(*(x.cpu() for x in head))
    t0 = time.perf_counter()
    cpu = cosp.cosp_simulator(key.cpu(), cpu_in, cfg)
    t_cpu = time.perf_counter() - t0
    pf = [prec_scops(x.qr + x.qs + x.qg, torch.zeros_like(x.qr),
                     o["frac_out"]) for x, o in ((head, card),
                                                 (cpu_in, cpu))]
    gate("prec_frac mismatches", float((pf[0].cpu() != pf[1]).sum()), 0)
    flips, total = satsim_compare(torch, card, cpu, cfg.ncolumns)
    del card, cpu, pf

    def run():
        return cosp.cosp_simulator(key, inp, cfg)
    t = walls(torch, run, 3)
    ev = time_ms(torch, run, 3)
    args, kw = qb_calls[0]
    radar = time_ms(torch, lambda: qb(*args, **kw), 3)
    print(f"  cosp_simulator wall {statistics.median(t) * 1e3:.1f} ms (median "
          f"of 3; {[round(x * 1e3, 1) for x in t]}; first call "
          f"{first * 1e3:.1f}), {ev:.1f} ms by CUDA events (mean of 3); "
          f"quickbeam_simulator alone {radar:.1f} ms ({100 * radar / ev:.1f}"
          f" % of it); peak device memory {peak / 2**20:.1f} MiB; the CPU "
          f"call on {n} points {t_cpu:.1f} s")
    del qb_calls, args, kw
    if profile:
        device_profile(torch, "cosp_simulator", run, 1, top=12)
    return dict(flips=flips, counts=total)


def parallel_phase(torch, step):
    """The refresh through the column sharding and the staged feed
    (parallel/): sharded over column_mesh() against the unsharded refresh,
    bitwise; two shards on the one card and a padded batch against the
    unpadded one; bench.py's staged-overlap workload through
    run_steps_overlapped against a serial loop, with a trace of its
    copies. Returns the launches of the sharded refresh."""
    import os

    from geosradiation_gridcomp_tpu_torch.driver.astronomy import \
        mean_cos_zenith
    from geosradiation_gridcomp_tpu_torch.driver.step import (
        radiation_refresh, sw_partition_bounds)
    from geosradiation_gridcomp_tpu_torch.kernels.build import (BUILD_DIR,
                                                                LAUNCHES)
    from geosradiation_gridcomp_tpu_torch.parallel.distributed import (
        StagedFeed, run_steps_overlapped)
    from geosradiation_gridcomp_tpu_torch.parallel.sharding import (
        column_mesh, pad_columns, run_sharded, shard_columns, tree_leaves,
        tree_map)
    from geosradiation_gridcomp_tpu_torch.scene import example_inputs

    inp, cfg, ict, icb = step["inp"], step["cfg"], step["ict"], step["icb"]
    mods = step["mods"]

    def refresh(x):
        """The step's refresh, its packing bounds taken from x as the step
        phase takes them."""
        bounds = [sw_partition_bounds(x.lons, x.lats, x.fcld, d, UTC, cfg)
                  for d in (DOY, DOY + 0.01)]
        nlit = None if any(b[0] is None for b in bounds) \
            else max(b[0] for b in bounds)
        ncld = None if any(b[1] is None for b in bounds) \
            else max(b[1] for b in bounds)
        return radiation_refresh(x, DOY, UTC, config=cfg, ict=ict, icb=icb,
                                 sw_nlit=nlit, sw_ncld=ncld, **mods)

    def differing(a, b, x):
        """The state fields of a and b that are not bitwise equal, and the
        dark columns where only cldfrc differs: a night column's McICA
        cover is computed when it falls inside the packing bound (nlit,
        rounded up to 256 columns) and reads clear beyond it, so it
        follows each shard's own bound, in the reference as here."""
        slr, lit = mean_cos_zenith(x.lons, x.lats, DOY, UTC,
                                   cfg.solar_dt / 3600.0)
        dark = ~((lit > 0.0) & (slr > 0.0))
        bad, ndark = [], 0
        for s, t in zip(a, b):
            for f in s._fields:
                u, v = getattr(s, f), getattr(t, f)
                if f == "cldfrc":
                    ndark = int((u != v).any(dim=1).sum())
                    u, v = u[~dark], v[~dark]
                if not torch.equal(u, v):
                    bad.append(f"{type(s).__name__}.{f}")
        return bad, ndark

    mesh = column_mesh()
    print(f"parallel: radiation_refresh through shard_columns(column_mesh()"
          f", inp) + run_sharded at {inp.t.shape[0]} x {NLEV}, mesh {mesh}:")
    want = refresh(inp)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    got = run_sharded(refresh, shard_columns(mesh, inp))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"  kernel launches in the parallel path: {launches}")
    require_launched(launches, "step")
    gate("sharded vs unsharded fields not bitwise equal",
         sum(not torch.equal(getattr(s, f), getattr(t, f))
             for s, t in zip(got, want) for f in s._fields), 0)
    got = run_sharded(refresh, shard_columns(mesh + mesh, inp))
    bad, ndark = differing(got, want, inp)
    gate(f"two shards of {inp.t.shape[0] // 2} columns on the one card: "
         f"fields not bitwise equal {bad[:3]}", len(bad), 0)
    print(f"  (cldfrc differs in {ndark} dark columns: each shard's own "
          f"packing bound; reported)")
    del got, want

    odd = example_inputs(8197, NLEV, seed=SEED, device=inp.t.device)
    padded, ncol = pad_columns(odd, 8)
    print(f"  pad_columns: {ncol} columns padded to {padded.t.shape[0]}")
    want = refresh(odd)
    got = run_sharded(refresh, shard_columns(mesh, padded))
    got = tuple(type(s)(*(x[:ncol] for x in s)) for s in got)
    bad, ndark = differing(got, want, odd)
    gate(f"padded vs unpadded first {ncol} columns: fields not bitwise "
         f"equal {bad[:3]}", len(bad), 0)
    print(f"  (cldfrc differs in {ndark} dark columns; reported)")
    del odd, padded, got, want

    # bench.py:126-180: 8 distinct host-resident batches of 4096 x NLEV,
    # seeds 0-7, the refresh without packing
    nbatch, nb = 8, 4096
    batches = [tree_map(lambda x: x.numpy(), example_inputs(
        nb, NLEV, seed=s, device="cpu")) for s in range(nbatch)]

    def step_fn(x):
        return radiation_refresh(x, DOY, UTC, config=cfg, ict=ict, icb=icb,
                                 **mods)

    def overlapped():
        outs = run_steps_overlapped(step_fn, batches)
        torch.cuda.synchronize()
        return outs

    def serial():
        feed, outs = StagedFeed(), []
        for b in batches:
            outs.append(step_fn(feed.put(b).get()))
            torch.cuda.synchronize()
        return outs

    order = ("overlapped", "serial", "serial", "overlapped", "overlapped",
             "serial")
    print(f"  staged feed: {nbatch} host batches of {nb} x {NLEV} through "
          f"run_steps_overlapped and a serial put/get/step/synchronize loop "
          f"({', '.join(order)}):")
    step_fn(StagedFeed().put(batches[0]).get())
    torch.cuda.synchronize()
    secs = {"overlapped": [], "serial": []}
    outs = {}
    for name in order:
        t0 = time.perf_counter()
        outs[name] = (overlapped if name == "overlapped" else serial)()
        secs[name].append(time.perf_counter() - t0)
    a = [x for o in outs["overlapped"] for x in tree_leaves(o)]
    b = [x for o in outs["serial"] for x in tree_leaves(o)]
    gate("overlapped vs serial outputs not bitwise equal",
         sum(not torch.equal(x, y) for x, y in zip(a, b)), 0)
    del outs, a, b
    rate = {k: nbatch * nb / statistics.median(v) for k, v in secs.items()}
    print(f"  overlapped {rate['overlapped']:.0f} columns/s, serial "
          f"{rate['serial']:.0f} columns/s (median of 3 rounds each; "
          f"rounds {[round(x * 1e3, 1) for x in secs['overlapped']]} / "
          f"{[round(x * 1e3, 1) for x in secs['serial']]} ms), ratio "
          f"{rate['overlapped'] / rate['serial']:.3f}")
    trace = os.path.join(os.path.dirname(BUILD_DIR), "staged_trace.json")
    copy_overlap(torch, overlapped, trace)
    return launches


def copy_overlap(torch, run, path):
    """torch.profiler trace of run(): on which streams the host-to-device
    copies from pinned memory (the staged inputs; the refresh's own
    copies, ROADMAP H3, come from pageable memory) and the kernels ran,
    and how much of those copies' time overlapped a kernel of another
    stream."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]

    def span(e):
        return e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("stream")
    htod = [e for e in events if e.get("cat") == "gpu_memcpy"
            and "HtoD" in e.get("name", "")]
    staged = [span(e) for e in htod if "Pinned" in e["name"]]
    kernels = [span(e) for e in events if e.get("cat") == "kernel"]
    overlap = 0.0
    for start, end, stream in staged:
        last = start
        for s, e in sorted((max(s, start), min(e, end))
                           for s, e, k in kernels
                           if k != stream and s < end and e > start):
            if e > max(s, last):
                overlap += e - max(s, last)
                last = e
    total = sum(e - s for s, e, _ in staged)
    print(f"  trace ({path}): {len(htod)} host-to-device copies, "
          f"{len(htod) - len(staged)} of them the refresh's own from "
          f"pageable memory, {len(staged)} from pinned memory "
          f"({total / 1e3:.3f} ms) on "
          f"streams {sorted({c[2] for c in staged})}, kernels on streams "
          f"{sorted({k[2] for k in kernels})}; {overlap / 1e3:.3f} ms "
          f"({100.0 * overlap / max(total, 1e-9):.1f} %) of the pinned "
          f"copies overlapped a kernel of another stream")


def device_profile(torch, label, fn, nprof, top=25):
    """torch.profiler over nprof calls of fn: the wall per call under the
    profiler, the device kernel time and launches per call, the top
    kernels by device time, and the device's idle share over the
    profiled span."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(nprof):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / nprof

    def on_device(e):
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    rows = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if on_device(e) and e.device_time_total > 0),
                  reverse=True)
    total = sum(r[0] for r in rows) / 1e3 / nprof
    print(f"  under the profiler: {wall * 1e3:.3f} ms per {label}, device "
          f"kernel time {total:.3f} ms in "
          f"{sum(r[1] for r in rows) / nprof:.0f} launches")
    for dt, count, key in rows[:top]:
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


def profile_phase(torch, step, nwall=30, nprof=5):
    """--profile: where the time of the full-width refresh goes."""
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

    device_profile(torch, "refresh", lambda: refresh(False), nprof)

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
# it: step, verify or profiling, its CUDA function's name)
SOURCES = {
    "mcica_optics_lw": (_CSRC + "mcica_lw.cu",
                        _REF + "ops/mcica_pallas.py:367", "step",
                        "mcica_lw_kernel"),
    "mcica_optics_sw": (_CSRC + "mcica_sw.cu",
                        _REF + "ops/mcica_pallas.py:588", "step",
                        "mcica_sw_kernel"),
    "taumol_lw": (_CSRC + "taumol_lw.cu",
                  _REF + "models/rrtmg/taumol_lw_pallas.py:457", "step",
                  "taumol_lw_kernel"),
    "rtrnmc": (_CSRC + "rtrnmc.cu",
               _REF + "models/rrtmg/rtrnmc_pallas.py:239", "step",
               "rtrnmc_kernel"),
    "taumol_sw": (_CSRC + "taumol_sw.cu",
                  _REF + "models/rrtmg/taumol_sw_pallas.py:246", "step",
                  "taumol_sw_kernel"),
    "spcvmc": (_CSRC + "spcvmc.cu",
               _REF + "models/rrtmg/spcvmc_pallas.py:454", "step",
               "spcvmc_kernel"),
    "mcica_subcols_raw": (_CSRC + "mcica_raw.cu",
                          _REF + "ops/mcica_pallas.py:483", "verify",
                          "mcica_raw_kernel"),
    "ffill": (_CSRC + "ffill.cu",
              "tools/profiling/fused_mcica_check.py:56", "profiling",
              "ffill_kernel"),
    "gather_rows": (_CSRC + "gather_micro.cu",
                    "tools/profiling/gather_micro.py:63", "profiling",
                    "gather_rows_kernel"),
    "gather_lanes": (_CSRC + "gather_micro.cu",
                     "tools/profiling/gather_micro.py:96", "profiling",
                     "gather_lanes_kernel"),
    # P3 runs K3's templated body, taumol_lw.cuh
    "taumol_lw_bisect": (_CSRC + "taumol_lw_bisect.cu",
                         "tools/profiling/taumol_lw_bisect.py:58",
                         "profiling", "taumol_lw_kernel"),
}


def require_launched(launches, path):
    """Raise unless every kernel of the path launched in its run."""
    for name, (_, _, p, _) in SOURCES.items():
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
    seconds = {}

    def timed(name, phase, *phase_args):
        t = time.perf_counter()
        out = phase(*phase_args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out
    launches, step, calls = timed("step", step_phase, torch, dev)
    results = timed("step kernels", step_kernel_phases, torch, dev, calls,
                    draw)
    timed("sync-free", sync_free_phase, torch, calls)
    del calls
    results.update(timed("verification and profiling kernels",
                         raw_and_profiling_kernel_phases, torch, dev, draw))
    if args.profile:
        timed("profile", profile_phase, torch, step)
    paths = {"step": launches, "verify": timed("verify", verify_path, torch),
             "profiling": timed("profiling", profiling_path, torch)}
    for path in ("verify", "profiling"):
        print(f"  kernel launches in the {path} path: {paths[path]}")
        require_launched(paths[path], path)
    paths["rats"] = timed("rats", rats_phase, torch, step, args.profile)
    timed("chou", chou_phase, torch, dev, args.profile)
    paths["rrtmgp"] = timed("rrtmgp", rrtmgp_phase, torch, step,
                            args.profile)
    paths["rrtmgp_native"] = timed("rrtmgp_native", rrtmgp_native_phase,
                                   torch, step, args.profile)
    paths["driver"] = timed("driver", driver_phase, torch, step,
                            args.profile)
    timed("satsim", satsim_phase, torch, dev, args.profile)
    paths["parallel"] = timed("parallel", parallel_phase, torch, step)
    print(f"phase seconds: {json.dumps(seconds)}")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "geosradiation_gridcomp_tpu"))
    if loaded:
        raise AssertionError(f"the port loaded {loaded[:5]}")

    kernels = []
    for name, (source, replaces, path, _) in SOURCES.items():
        r = results[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            path=path, launches=paths[path][name],
            launches_per_refresh=paths[path][name] if path == "step"
            else 0,
            launches_by_path={p: n[name] for p, n in paths.items()
                              if n.get(name)},
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            device_ms=r["device_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
