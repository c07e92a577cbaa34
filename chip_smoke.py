#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1 McICA + LW cloud optics, K2 McICA + SW
cloud optics, K3 taumol-LW, K4 rtrnmc, K5 taumol-SW, K6 spcvmc, K7 raw
McICA draws, K8 RRTMGP's McICA draws, K9 the LW table rows, P1 forward
fill, P2 table gathers, P3 taumol-LW bisection)
from geosradiation_gridcomp_tpu_torch/csrc with nvcc for sm_90a, one
nvcc per source side by side, then:

1. step phase at 8192 columns x 72 levels (the reference benchmark's
   workload, bench.py:190-228): radiation_refresh + radiation_update
   through their entry points on the realistic multi-deck scene, doy 172,
   12 UTC, with sw_partition_bounds daylight packing. The entries are
   captured (driver/compiled.py, the counterpart of the reference's
   jax.jit): the first call warms up, captures a CUDA graph per static
   key and replays it (the scheme entries rrtmg_sw and rrtmg_lw run
   their bodies inside that capture and record no graph of their own),
   and every kernel K1-K6 must launch exactly once and K9 twice (the LW
   cloud rows and Planck rows; LAUNCHES counts each replay's recorded
   launches); the capture's own time and the graph pool's size are
   printed; a second call replays, counts them so again and returns
   outputs bitwise equal to the
   first's and sharing no storage with them; the first call of each
   kernel's wrapper is recorded through the eager bodies
   (radiation_refresh_eager, radiation_update_eager, op by op: every
   captured entry they reach runs its body, driver.compiled.
   disable_capture), and the replays must be bitwise equal to the eager
   bodies at doy 172 and at 172.001,
   which no graph was captured at;
   every IrradState field and LW export must agree with the plain path on
   the same card to relmax <= 5e-5, every SolarState field and SW export
   to relmax <= 5e-4 with at most 0.5 % of columns beyond 5e-5
   (tools/verify_tpu.py:279-281); the heating rates in the reference's
   form (tests/test_accuracy.py:142-152): the flux-divergence error in
   every layer and the relative rate where dp > 100 Pa, each within the
   bound the flux gates imply (heating_rate_gates); fluxes must be
   physical; in one call, plain, eager, captured, captured, eager,
   plain: the refresh's wall time (host clock) and CUDA-event time on
   each route, the update's likewise, and the peak device memory of an
   eager and a captured refresh beside the graph pool;
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
   pipes; K9's cloud rows and Planck rows, recorded as the refresh's LW
   solve called band_abs_coeffs_lw and lw_rows_cuda.planck_rows, each
   bitwise equal to its plain twin, with the route's, the kernel's and
   the twins' times, the twins' tab[index] interpolations alone
   (library_ms) and the bytes' bound; then K1, K2, K4, K5, K6 and K9's
   wrappers once more on those inputs,
   and the whole refresh + update replayed and through the eager bodies,
   under torch.cuda.set_sync_debug_mode("error"), where any call that
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
   index_select (library_ms: the faster); gather_lanes beside its library
   call, one advanced index tabT[g, idx] that gives its block layout
   (exactly equal; library_ms); P3's full variant equal to K3
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
   8192 x 72 with the step's ict/icb, through the kernels: its 8 solves
   replay one captured rrtmg_lw graph (the first call captures it: its
   time and the graph pool's growth are printed), K1, K3 and K4 must
   launch exactly 8 times each, K9 16 times, and nothing else; the
   states bitwise
   equal to the eager body's (op by op, driver.compiled.disable_capture)
   at doy 172 and 172.001; K3 within relmax 5e-4 of its twin in every
   band on each gas's inputs, recorded on the eager body (the zeroed gas
   drives taumol's specparm to its edges); every gas's RatsState within
   relmax 5e-5 of the plain twins on the card (the LW gate);
   rats_update's CO2 and CH4 TOA forcing, each column mean positive and
   CO2's above CH4's; the replayed and the eager refresh under
   set_sync_debug_mode("error"); eager, captured, captured, eager: the
   wall time (median of 5) and CUDA-event time of each; the peak device
   memory of each;
7. chou phase: radiation_refresh + radiation_update with the Chou-Suarez
   SW and LW schemes at 8192 x 72 on the card through the captured
   entries, where no CUDA kernel of the port may launch; the first
   call's time and the pool's growth; every SolarState and IrradState
   field and every flux export within relmax 5e-5 of the same functions
   on the CPU on the first 256 columns, the heating rates in the
   reference's form (heating_rate_gates at those flux gates); SW net /
   TOA insolation in [0, 1] and OLR in 120-340 W/m^2; the replays
   bitwise equal to the eager body (op by op) at doy 172 and 172.001;
   replay and eager body under set_sync_debug_mode("error"); eager,
   captured, captured, eager: wall (median of 3) and CUDA-event time;
   the peak device memory of each route; then the phase's graphs are
   dropped (drop_graphs), so later captures reuse their pool blocks;
8. rrtmgp phase: radiation_refresh + radiation_update with the RRTMGP SW
   and LW schemes through the RRTMG-reduced facade at 8192 x 72 through
   the captured entries: K3, K4, K5 and K10 (the SW solver, both
   streams) must launch exactly once each per replay, K8 twice (SW, LW),
   K9 twice (the gas optics' Planck rows, the band cloud optics' cloud
   rows) and nothing else (K5, K8 and K10 on all 8192 columns: the facade
   does not pack daylight); the first call's time and the pool's growth;
   K3 and K5 within relmax 5e-4 of their twins in every band and K4 in
   every output, K8's mask and zcw bitwise equal to its twin's for both
   g-point counts, and K10's six profiles within relmax 5e-4 of its
   twin's with at most 0.5 % of columns beyond 5e-5, on the inputs the
   eager body gives them (recorded there: a replay calls no wrapper),
   with K8's and K10's route, device, plain and bound times; the replays
   bitwise equal to the eager body at doy 172 and 172.001; every
   IrradState field and LW export within 5e-5 of plain=True on the
   card, every SolarState field and SW export within 5e-4 with at most
   0.5 % of columns beyond 5e-5, the heating rates in the reference's
   form; SW net / TOA
   insolation in [0, 1] and OLR in 150-350 W/m^2; replay and eager body
   under set_sync_debug_mode("error"); the clear-sky difference from the
   RRTMG step (flcn, flc); eager, captured, captured, eager: wall
   (median of 3) and CUDA-event time; the plain refresh's wall and the
   peak device memory of each route; then the phase's graphs are
   dropped;
9. rrtmgp_native phase: the same through the native engine, on a
   synthetic 2-band coefficient set written to build/ (a numpy copy of
   the reference's tests/test_rrtmgp_engine.py:make_kdist), at 8192 x 72
   through the captured entries: K8 must launch twice (SW, LW), K9 once
   (the LW band cloud optics' cloud rows) and no other kernel, olrb has
   the
   set's 2 bands, every state field and export within 5e-5 of the CPU
   on the first 256 columns (the grazing-sun columns, cos zenith under
   1e-4, reported apart: there the reference's two mu0 floors make the
   normalized SW state follow the card's and the CPU's cosine itself),
   the heating rates in the reference's form, physics; the replays
   bitwise equal to the eager body at two doy values, both sync-free;
   both routes' wall and CUDA-event times, the first call, the pool and
   the peak memory; then the phase's graphs are dropped;
10. driver phase: a RadiationClock (30 min heartbeat, hourly refresh) for
   4 heartbeats at 8192 x 72 with the kernels: validate_inputs and
   radiation_refresh (captured) + rats_refresh (rrtmg_lw captured) on
   the alarm, radiation_update (captured) + rats_update every heartbeat,
   check_finite on every new state and export; then the same run
   stopped after heartbeat 2, checkpointed
   (build/driver_checkpoint.npz) and restarted from
   load_checkpoint(device="cuda"): every export of the restarted run
   bitwise equal to the uninterrupted run's; the update's wall time per
   heartbeat; the alarm's radiation_refresh + rats_refresh replayed
   bitwise equal to the eager bodies at two doy values, both under
   set_sync_debug_mode("error"), and both routes' times;
11. satsim phase: the captured cosp_simulator (SatsimConfig(): 50
   subcolumns, every simulator, the 40-bin CloudSat stat grid) at 8192
   points x 50 subcolumns x 72 levels on a scene made from the realistic
   one (satsim_inputs), key 11: the first call's ms and the growth of
   the graph pool it captures into, one of its own; no kernel may launch; every group and key present, each value
   finite or one of the reference's fill values, the ranges the
   reference's satsim tests check; the same call on the first 256 points
   on the card and on the CPU: frac_out, prec_frac and the MODIS phases
   identical, fill values in the same places, every other float within
   relmax 5e-5 (meantaucld in albedo space), the histogram counts
   compared and any flipped count reported; the replays bitwise equal to
   the eager body run op by op under disable_capture at keys 11 and 12;
   both routes under set_sync_debug_mode("error"); eager / captured /
   captured / eager wall and CUDA-event ms; the peak memory of each
   route beside the pool's; the radar alone on the arguments of an eager
   call; then the phase's graph is dropped;
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
   kernels, the count of other host-to-device copies, and the share of
   the pinned copies' time that overlapped a kernel of another stream.
   Every refresh here goes through the captured entry: each new shape or
   packing bound captures its own graph.

Then it checks that neither jax nor any module of the reference package
geosradiation_gridcomp_tpu was loaded.

    python3 chip_smoke.py --profile

adds, after the step phase, where the time of the full-width refresh
goes, on the eager and on the captured route: its wall time over 30
runs and CUDA-event time, the device time of each CUDA kernel, the
launches per refresh and the device's idle share (torch.profiler), the
same of the update, whether the profiler names K1-K6 inside a replay,
a check that the refresh calls neither ops.mcica.subcolumn_keys nor
band_optics_coeffs_sw (K1 and K2 derive the subkeys, K2 the SW band
optics, on the card), and the solar_refresh and irrad_refresh stages
alone, beside subcolumn_keys, now off the kernel path (CUDA events);
and the same device profile of the RATS refresh, the Chou refresh +
update, the RRTMGP facade refresh and the native RRTMGP refresh + update,
each replayed and eager (op by op), of a heartbeat's radiation_update +
rats_update and of cosp_simulator, replayed and eager.

Prints the card's name and power limit, a JSON line with each kernel's
launches (counted on the path named by its `path`: step, verify or
profiling, and K8's rrtmgp; launches_per_refresh for the step kernels
and K8; launches_by_path on every path that launched it, K1, K3, K4 and
K9 also on rats, K3, K4, K5 and K9 also on rrtmgp, K8 and K9 also on
rrtmgp_native, K1-K6 and K9 also on driver and parallel), error,
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
    results["lw_rows"] = lw_rows_result(torch, calls)
    return results


def lw_rows_result(torch, calls):
    """K9 on the inputs the full-width refresh's eager body gave it (calls
    from kernel_ab.recording: "lw_rows_cloud", band_abs_coeffs_lw as
    rrtmg_lw calls it, and "lw_rows_planck", lw_rows_cuda.planck_rows as
    setcoef_lw calls it): the cloud rows and the Planck rows each bitwise
    equal to the plain twin's (band_abs_coeffs_lw under twins(),
    planck_rows_plain); the route's (CUDA events), the kernel's (device)
    and the twins' times summed over the two launches of a LW solve;
    library_ms the twins' tab[index] interpolations alone (both rows
    gathered at the twin's indices and weights, computed beforehand, and
    lo + fint (hi - lo)); the bound: each input read once and each output
    written once (roofline/K9.py's count)."""
    from geosradiation_gridcomp_tpu_torch.models.rrtmg import cldprmc_lw
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.setcoef_lw import \
        planck_rows_plain

    fc, ac, kc = calls["lw_rows_cloud"]
    fp, ap, kp = calls["lw_rows_planck"]
    (reice, reliq, cloud_tables), iceflag = ac[:3], kc.get("iceflag", 3)
    tavel, tz, tbound, semiss, totplnk, dtab, dudts = ap
    routes = {"cloud": lambda: fc(*ac, **kc), "planck": lambda: fp(*ap, **kp)}
    twins = {"cloud": lambda: on_twins(fc)(*ac, **kc),
             "planck": lambda: planck_rows_plain(
                 tavel, tz, tbound, semiss,
                 dict(totplnk=totplnk, totplnkderiv=dtab), dudts)}
    print(f"K9 (lw_rows) at {tuple(reliq.shape)}, iceflag {iceflag}, dudts "
          f"{dudts}:")
    # what K9 reads and writes: no ice rows for iceflags 0 and 1, no
    # dplankbnd without dudts
    written = {"cloud": (0, 1) if iceflag >= 2 else (1,),
               "planck": (0, 1, 2, 3) if dudts else (0, 2, 3)}
    moved = nbytes(reice if iceflag >= 2 else None, reliq, tavel, tz, tbound,
                   semiss)
    for name in routes:
        got, want = routes[name](), twins[name]()
        unequal = sum(int((a != b).sum()) for a, b in zip(got, want))
        gate(f"K9 {name} rows vs its twin: unequal", float(unequal), 0)
        if not all(a.shape == b.shape and torch.equal(a, b)
                   for a, b in zip(got, want)):
            raise AssertionError(f"K9's {name} rows are not bitwise its "
                                 f"twin's")
        moved += nbytes([got[i] for i in written[name]])
    del got, want

    def rows(tab, factor):
        index = torch.clamp(torch.floor(factor).to(torch.int64), 1,
                            tab.shape[0] - 1)
        return tab, index, factor - index.to(factor.dtype)
    interps = [rows(cloud_tables["absliq1"], reliq - 1.5)]
    if iceflag >= 2:
        interps.append(rows(cloud_tables[cldprmc_lw.ICE_TABLES[iceflag]],
                            (reice - 2.0) / 3.0))
    interps += [rows(totplnk, t - 159.0) for t in (tavel, tz, tbound)]
    if dudts:
        interps.append(rows(dtab, tbound - 159.0))
    library = lambda: [cldprmc_lw._interp_rows(*r) for r in interps]
    r = dict(max_abs_err=0.0, library_ms=time_ms(torch, library, 20))
    r["ms"] = sum(time_ms(torch, f, 20) for f in routes.values())
    r["device_ms"] = sum(kernel_device_ms(torch, "lw_rows", f)
                         for f in routes.values())
    r["plain_ms"] = sum(time_ms(torch, f, 3) for f in twins.values())
    r["bound_ms"], r["bound_by"] = bound(moved)
    print(f"  a LW solve (cloud + Planck): route {r['ms']:.4f} ms, device "
          f"{r['device_ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, its "
          f"tab[index] interpolations {r['library_ms']:.3f} ms), bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']} "
          f"({100 * r['bound_ms'] / r['device_ms']:.1f} % of it)")
    return r


def sync_free_phase(torch, calls, step):
    """K1, K2, K4, K5, K6 and K9's wrappers on the refresh's inputs, then the
    whole refresh + update, replayed and through the eager bodies, under
    set_sync_debug_mode("error"): a call that synchronises the stream (a
    copy from host memory, a read of a device value) fails."""
    from geosradiation_gridcomp_tpu_torch.tools.profiling.kernel_ab import \
        sync_free

    def step_run(eager):
        states = step["refresh"](eager=eager)
        return step["update"](states, eager=eager)

    print("sync-free, set_sync_debug_mode('error'):")
    runs = [(name, lambda fn=fn, a=args, kw=kw: fn(*a, **kw))
            for name, (fn, args, kw) in ((n, calls[n]) for n in (
                "mcica_optics_lw", "mcica_optics_sw", "rtrnmc", "taumol_sw",
                "spcvmc", "lw_rows_cloud", "lw_rows_planck"))]
    runs += [("captured refresh + update", lambda: step_run(False)),
             ("eager refresh + update", lambda: step_run(True))]
    for name, run in runs:
        res = sync_free(torch, run)
        print(f"  {name:36s} {'PASS' if res is True else res}")
        if res is not True:
            raise AssertionError(f"{name}: {res}")


def first_sync(torch, run):
    """Where run() first synchronises the stream: the innermost frame of
    the port in the traceback of the error set_sync_debug_mode("error")
    raises there, or None when it never does."""
    import traceback

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
        return None
    except RuntimeError as e:
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if "geosradiation_gridcomp_tpu_torch" in f.filename]
        if not frames:
            return str(e).splitlines()[0]
        f = frames[-1]
        return (f"{f.filename.split('geosradiation_gridcomp_tpu_torch/')[-1]}"
                f":{f.lineno} {f.line}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


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
    # the library: one advanced-indexing call that gives the kernel's
    # block layout directly, [nblk, ng, 64, 128], on int64 indices (as
    # gather_rows' library calls take them)
    g = torch.arange(tabt.shape[0], device=dev)[None, :, None, None]
    blocks = idx2d.view(-1, 1, 64, 128).long()
    library = lambda: tabt[g, blocks]
    exact("gather_lanes library call", library().reshape(out.shape), out)
    lib_ms = time_ms(torch, library, 20)
    print(f"P2 gather_lanes at {n} points, {rows} x 16 table: library "
          f"tabT[g, idx] {lib_ms:.4f} ms")
    timed("gather_lanes", lambda: gather_lanes(idx2d, tabt),
          lambda: gather_lanes_plain(idx2d, tabt),
          exact("gather_lanes", out, gather_lanes_plain(idx2d, tabt)),
          bound(nbytes(idx2d, tabt, out)), n_plain=20, library_ms=lib_ms)

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


def pool_bytes(torch, dev, pool=None):
    """Bytes the caching allocator holds for the captured graphs' shared
    memory pool on dev (driver/compiled.py:graph_pool), or for pool."""
    from geosradiation_gridcomp_tpu_torch.driver.compiled import graph_pool
    pool = tuple(graph_pool(dev)[0] if pool is None else pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == pool)


def step_phase(torch, dev):
    """radiation_refresh + radiation_update at full width through their
    captured entries, as bench.py drives the reference's jitted ones:
    the first call captures, and K1-K6 launch once per refresh; the
    replays bitwise equal to the eager bodies at the captured doy and at
    another; the step's gates against plain=True; eager and captured
    times in one call. Returns the launches, the step's set-up and the
    recorded first call of each step kernel (through the eager body)."""
    from geosradiation_gridcomp_tpu_torch.config import RadiationConfig
    from geosradiation_gridcomp_tpu_torch.driver.step import (
        radiation_refresh, radiation_refresh_eager, radiation_update,
        radiation_update_eager, sw_partition_bounds)
    from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.lw import RRTMGLW
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.sw import RRTMGSW
    from geosradiation_gridcomp_tpu_torch.parallel.sharding import \
        tree_leaves
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

    # the eager route runs op by op: the scheme entries the eager refresh
    # reaches run their bodies too (op_by_op), as before they were
    # captured entries themselves
    def refresh(plain=False, eager=False, doy=DOY):
        entry = op_by_op(radiation_refresh_eager) if eager \
            else radiation_refresh
        return entry(inp, doy, UTC, config=cfg, ict=ict, icb=icb,
                     sw_nlit=nlit, sw_ncld=ncld, plain=plain, **mods)

    def update(states, eager=False, doy=DOY):
        entry = op_by_op(radiation_update_eager) if eager \
            else radiation_update
        return entry(*states, inp.tsinst + 0.5, inp.lons, inp.lats, inp.ple,
                     doy, UTC + 0.25, config=cfg)

    def run(plain=False, eager=False, doy=DOY):
        sol, irr = refresh(plain, eager, doy)
        return sol, irr, update((sol, irr), eager, doy)

    def unequal(a, b):
        return sum(not torch.equal(x, y)
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    print(f"step: radiation_refresh + radiation_update at {ncol} x {NLEV}, "
          f"ict={ict} icb={icb}, sw_nlit={nlit} sw_ncld={ncld}:")
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved(dev)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    sol, irr = refresh()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    upd = update((sol, irr))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(LAUNCHES)
    print(f"  kernel launches in the main path: {launches}")
    require_launched(launches, "step")
    gate("step kernels not launched as often as a refresh launches them",
         sum(n != per_refresh(k) for k, n in launches.items()), 0)
    print(f"  first calls (warm-up + capture + replay): refresh "
          f"{(t1 - t0) * 1e3:.1f} ms, update {(t2 - t1) * 1e3:.1f} ms; graph "
          f"pool {pool_bytes(torch, dev) / 2**20:.1f} MiB, reserved "
          f"{reserved / 2**20:.1f} -> "
          f"{torch.cuda.memory_reserved(dev) / 2**20:.1f} MiB")
    LAUNCHES.clear()
    again = run()
    torch.cuda.synchronize()
    gate("replay: step kernels not counted as a refresh launches them",
         sum(LAUNCHES.get(k, 0) != per_refresh(k) for k, v in SOURCES.items()
             if v[2] == "step") + len(set(LAUNCHES) - set(launches)), 0)
    gate("replay vs first call: leaves not bitwise equal",
         unequal(again, (sol, irr, upd)), 0)
    gate("replay outputs sharing storage with the first call's",
         len({t.untyped_storage().data_ptr() for t in tree_leaves(again)}
             & {t.untyped_storage().data_ptr()
                for t in tree_leaves((sol, irr, upd))}), 0)
    del again
    with recording() as calls:
        eager = run(eager=True)
    gate(f"captured vs eager at doy {DOY}: leaves not bitwise equal",
         unequal((sol, irr, upd), eager), 0)
    other = DOY + 0.001
    got, want = run(doy=other), run(eager=True, doy=other)
    gate(f"captured vs eager at doy {other}: leaves not bitwise equal",
         unequal(got, want), 0)
    moved = unequal(got, eager)
    print(f"  {moved} of {len(tree_leaves(got))} leaves differ between doy "
          f"{DOY} and {other} (the doy reaches the graph)")
    if not moved:
        raise AssertionError("the replay at another doy gave the captured "
                             "doy's results")
    del eager, got, want
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

    # plain, eager, captured, captured, eager, plain: compare within one
    # call; wall = host clock between two synchronisations (median of 5),
    # CUDA events = back-to-back calls (mean of 10)
    states = (sol, irr)
    fns = {"plain": lambda: refresh(plain=True),
           "eager": lambda: refresh(eager=True), "captured": refresh,
           "eager update": lambda: update(states, eager=True),
           "captured update": lambda: update(states)}
    t = {k: [] for k in fns}
    ev = {k: [] for k in fns}
    for k in ("plain", "eager", "captured", "captured", "eager", "plain",
              "eager update", "captured update", "captured update",
              "eager update"):
        t[k].append(statistics.median(walls(torch, fns[k], 5)))
        if k != "plain":
            ev[k].append(time_ms(torch, fns[k], 10))
    peak = {}
    for k in ("eager", "captured"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fns[k]()
        torch.cuda.synchronize()
        peak[k] = torch.cuda.max_memory_allocated() / 2**20
    best = {k: min(v) for k, v in t.items()}
    print(f"  radiation_refresh wall (median of 5, better of 2 rounds): "
          f"captured {best['captured'] * 1e3:.3f} ms "
          f"({ncol / best['captured']:.0f} columns/s), eager "
          f"{best['eager'] * 1e3:.3f} ms ({ncol / best['eager']:.0f} "
          f"columns/s), plain {best['plain'] * 1e3:.2f} ms; CUDA events "
          f"(mean of 10) captured {ev['captured']}, eager {ev['eager']} ms; "
          f"rounds captured {[round(x * 1e3, 3) for x in t['captured']]} / "
          f"eager {[round(x * 1e3, 3) for x in t['eager']]} / plain "
          f"{[round(x * 1e3, 1) for x in t['plain']]} ms")
    print(f"  radiation_update wall (median of 5): captured "
          f"{[round(x * 1e3, 3) for x in t['captured update']]}, eager "
          f"{[round(x * 1e3, 3) for x in t['eager update']]} ms; CUDA events "
          f"(mean of 10) captured {ev['captured update']}, eager "
          f"{ev['eager update']} ms")
    # what a capture costs in a warm process: a key not seen yet (the
    # refresh without daylight packing), its first call beside that key's
    # eager body and replays
    def unpacked(entry):
        return lambda: entry(inp, DOY, UTC, config=cfg, ict=ict, icb=icb,
                             **mods)
    first = walls(torch, unpacked(radiation_refresh), 1)[0]
    later = {k: statistics.median(walls(torch, unpacked(entry), 5))
             for k, entry in (("replays", radiation_refresh),
                              ("eager", op_by_op(radiation_refresh_eager)))}
    print(f"  a new key in a warm process (no packing): first call "
          f"(warm-up + capture + replay) {first * 1e3:.1f} ms, then "
          f"replays {later['replays'] * 1e3:.3f} ms and the eager body "
          f"{later['eager'] * 1e3:.3f} ms (medians of 5)")
    print(f"  peak device memory of one refresh: eager {peak['eager']:.1f} "
          f"MiB, captured {peak['captured']:.1f} MiB beside the graph pool's "
          f"{pool_bytes(torch, dev) / 2**20:.1f} MiB (reserved "
          f"{torch.cuda.memory_reserved(dev) / 2**20:.1f} MiB)")
    return launches, dict(inp=inp, cfg=cfg, ict=ict, icb=icb, nlit=nlit,
                          ncld=ncld, mods=mods, refresh=refresh,
                          update=update), calls


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


def op_by_op(fn):
    """fn with every captured entry it reaches on its body
    (driver.compiled.disable_capture, jax.disable_jit's counterpart): the
    eager route, op by op, as it was timed before the scheme entries were
    captured."""
    from geosradiation_gridcomp_tpu_torch.driver.compiled import \
        disable_capture

    def run(*args, **kwargs):
        with disable_capture():
            return fn(*args, **kwargs)
    return run


def on_twins(fn):
    """fn with every kernel it reaches on its plain twin
    (kernels.twins.twins): the reference the kernels are held to."""
    from geosradiation_gridcomp_tpu_torch.kernels.twins import twins

    def run(*args, **kwargs):
        with twins():
            return fn(*args, **kwargs)
    return run


def unequal_leaves(torch, a, b):
    """How many leaves of a and b differ (not bitwise equal)."""
    from geosradiation_gridcomp_tpu_torch.parallel.sharding import \
        tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        raise AssertionError(f"{len(la)} leaves against {len(lb)}")
    return sum(not torch.equal(x, y) for x, y in zip(la, lb))


def first_call(torch, dev, run):
    """The first call of run with a new key (warm-up + capture + replay):
    (its result, its wall ms, the MiB the shared graph pool grew by)."""
    torch.cuda.synchronize()
    pool = pool_bytes(torch, dev)
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t0) * 1e3,
            (pool_bytes(torch, dev) - pool) / 2**20)


def route_times(torch, label, captured, eager_run, n):
    """eager, captured, captured, eager in one call: the wall (host clock
    between two synchronisations, median of n) and the CUDA-event time
    (mean of n back-to-back calls) of each; prints them and returns
    {route: ([walls ms], [events ms])}."""
    fns = {"captured": captured, "eager": eager_run}
    out = {k: ([], []) for k in fns}
    for k in ("eager", "captured", "captured", "eager"):
        out[k][0].append(statistics.median(walls(torch, fns[k], n)) * 1e3)
        out[k][1].append(time_ms(torch, fns[k], n))
    f = lambda xs: " / ".join(f"{x:.3f}" for x in xs)
    print(f"  {label}: wall (median of {n}) captured "
          f"{f(out['captured'][0])}, eager {f(out['eager'][0])} ms; CUDA "
          f"events (mean of {n}) captured {f(out['captured'][1])}, eager "
          f"{f(out['eager'][1])} ms")
    return out


def sync_free_gate(torch, name, run):
    """Raise unless run() goes through under set_sync_debug_mode("error")
    (first_sync finds no blocker)."""
    where = first_sync(torch, run)
    print(f"  {name} under set_sync_debug_mode('error'): "
          f"{'no synchronising call' if where is None else where}")
    if where is not None:
        raise AssertionError(f"{name} synchronises the stream at {where}")


def replay_vs_eager(torch, label, captured, eager_run, doys, what="doy"):
    """Gate: captured(doy) bitwise equal to eager_run(doy) at each doy (or
    at each value of what the two take)."""
    for doy in doys:
        n = unequal_leaves(torch, captured(doy), eager_run(doy))
        gate(f"{label} replay vs eager body at {what} {doy}: leaves not "
             f"bitwise equal", n, 0)


def peak_mib(torch, run):
    """Peak device memory allocated (MiB) over one call of run."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20


def drop_graphs(torch, dev, config, entries=None):
    """Drop the graphs of config of the captured entries (by default the
    refresh and the update) once its phase is done: their blocks return
    to the shared pool, where later captures reuse them, instead of each
    phase's key adding its share (the Chou-Suarez and RRTMGP keys hold
    some 12 and 18 GB)."""
    from geosradiation_gridcomp_tpu_torch.driver.step import (
        radiation_refresh, radiation_update)
    n = 0
    for entry in entries or (radiation_refresh, radiation_update):
        for key in [k for k in entry.graphs if ("config", config) in k[0]]:
            del entry.graphs[key]
            n += 1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"  dropped this phase's {n} graphs: pool "
          f"{pool_bytes(torch, dev) / 2**20:.1f} MiB, reserved "
          f"{torch.cuda.memory_reserved(dev) / 2**20:.1f} MiB")


def rats_phase(torch, step, profile=False):
    """RATS at full width through rats_refresh, whose 8 solves replay one
    captured rrtmg_lw graph: K1, K3 and K4 8 times each over the replays;
    the states bitwise equal to the eager body's (op_by_op), on which
    K3's inputs are recorded and held to its twin; against the plain
    twins; the replays and the eager body sync-free; both routes' times,
    the first call and the pool (with profile, where its time goes).
    Returns the launches of the captured run."""
    from geosradiation_gridcomp_tpu_torch.driver.diagnostics import (
        RATS_GASES, rats_refresh, rats_update)
    from geosradiation_gridcomp_tpu_torch.driver.radiation import \
        irrad_refresh
    from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
    from geosradiation_gridcomp_tpu_torch.models.rrtmg import lw as lwm
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw import (
        NGS_LW, taumol_lw)

    inp, cfg, ict, icb = step["inp"], step["cfg"], step["ict"], step["icb"]
    lw, dev = step["mods"]["lw"], inp.t.device

    def refresh(doy=DOY):
        return rats_refresh(inp, doy, cfg, ict, icb, lw=lw)
    eager_refresh = op_by_op(refresh)

    print(f"rats: rats_refresh over {len(RATS_GASES)} gases at "
          f"{inp.t.shape[0]} x {NLEV}:")
    LAUNCHES.clear()
    rats, first_ms, pool_mib = first_call(torch, dev, refresh)
    launches = dict(LAUNCHES)
    print(f"  kernel launches in the rats path: {launches}")
    want = {k: len(RATS_GASES) * per_refresh(k)
            for k in ("mcica_optics_lw", "taumol_lw", "rtrnmc", "lw_rows")}
    if launches != want:
        raise AssertionError(f"rats path launched {launches}, not {want}")
    keys = [k for k in lwm.rrtmg_lw.graphs if ("lw", lw) in k[0]]
    print(f"  first call (rrtmg_lw's warm-up + capture, 8 replays) "
          f"{first_ms:.1f} ms; graph pool +{pool_mib:.1f} MiB for "
          f"{len(keys)} rrtmg_lw key")
    gate("rrtmg_lw keys of the 8 solves, beyond one", len(keys) - 1, 0)
    # K3's inputs of each solve, recorded on the eager body (a replay
    # calls no wrapper), to hold K3 to its twin on them
    k3, k3_calls = lwm.taumol_lw_fast, []

    def k3_recorded(*args, **kwargs):
        k3_calls.append((args, kwargs))
        return k3(*args, **kwargs)
    lwm.taumol_lw_fast = k3_recorded
    try:
        eager_rats = eager_refresh()
    finally:
        lwm.taumol_lw_fast = k3
    gate("rats replay vs eager body: leaves not bitwise equal",
         unequal_leaves(torch, rats, eager_rats), 0)
    del eager_rats
    replay_vs_eager(torch, "rats", refresh, eager_refresh, (DOY + 0.001,))
    for gas, (args, kwargs) in zip(RATS_GASES, k3_calls):
        err = max(band_relmax(a, b, NGS_LW) for a, b in zip(
            k3(*args, **kwargs), taumol_lw(*args, **kwargs)))
        gate(f"{gas} K3 vs its twin, worst band", err, 5e-4)
    del k3_calls
    plain = on_twins(refresh)()
    for g, gas in enumerate(RATS_GASES):
        err, field = max((relmax(getattr(rats, f)[g], getattr(plain, f)[g]),
                          f) for f in rats._fields)
        gate(f"{gas} RatsState relmax, worst ({field})", err, 5e-5)
    del plain
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
    sync_free_gate(torch, "rats_refresh replayed", refresh)
    sync_free_gate(torch, "rats_refresh eager", eager_refresh)
    route_times(torch, "rats_refresh", refresh, eager_refresh, 5)
    print(f"  peak device memory of one rats_refresh: eager "
          f"{peak_mib(torch, eager_refresh):.1f} MiB, replayed "
          f"{peak_mib(torch, refresh):.1f} MiB")
    if profile:
        device_profile(torch, "RATS refresh, replayed", refresh, 3, top=8)
        device_profile(torch, "RATS refresh, eager", eager_refresh, 3,
                       top=8)
    return launches


def chou_phase(torch, dev, profile=False):
    """The Chou-Suarez schemes at full width on the card through the
    captured radiation_refresh + radiation_update, no kernel launched;
    against the same functions on the CPU on the first 256 columns; the
    replays bitwise equal to the eager body (op_by_op) at two doy values;
    replay and eager body sync-free; both routes' times, the first call,
    the pool and the peak memory (with profile, where their time goes)."""
    from geosradiation_gridcomp_tpu_torch.config import (RadiationConfig,
                                                         Scheme)
    from geosradiation_gridcomp_tpu_torch.driver.radiation import \
        AtmosInputs
    from geosradiation_gridcomp_tpu_torch.driver.step import (
        radiation_refresh, radiation_refresh_eager, radiation_update)
    from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
    from geosradiation_gridcomp_tpu_torch.scene import example_inputs

    cfg = RadiationConfig(sw_scheme=Scheme.CHOU, lw_scheme=Scheme.CHOU)
    inp = example_inputs(NCOL_SLICE, NLEV, seed=SEED, device=dev)
    ple0 = inp.ple[0].cpu().numpy()
    ict, icb = cfg.superlayer_indices(0.5 * (ple0[1:] + ple0[:-1]))

    def refresh(doy=DOY, x=inp, entry=radiation_refresh):
        return entry(x, doy, UTC, config=cfg, ict=ict, icb=icb)
    eager_refresh = op_by_op(
        lambda doy=DOY: refresh(doy, entry=radiation_refresh_eager))

    def update(states, x=inp):
        return radiation_update(*states, x.tsinst + 0.5, x.lons, x.lats,
                                x.ple, DOY, UTC + 0.25, config=cfg)

    print(f"chou: Chou-Suarez radiation_refresh + radiation_update at "
          f"{NCOL_SLICE} x {NLEV}, ict={ict} icb={icb}:")
    LAUNCHES.clear()
    (sol, irr), first_ms, pool_mib = first_call(torch, dev, refresh)
    upd = update((sol, irr))
    torch.cuda.synchronize()
    if LAUNCHES:
        raise AssertionError(f"the Chou path launched {dict(LAUNCHES)}")
    print(f"  first call (warm-up + capture + replay) {first_ms:.1f} ms; "
          f"graph pool +{pool_mib:.1f} MiB for the key")
    n = 256
    head = AtmosInputs(*(x[:n].cpu() for x in inp))
    states_c = refresh(x=head)
    cpu = (*states_c, update(states_c, head))
    pairs = state_and_export_pairs(sol, irr, upd, cpu)
    err, name = max((relmax(a[:n].cpu(), b), name) for name, a, b in pairs)
    gate(f"card vs CPU relmax, worst of {len(pairs)} ({name})", err, 5e-5)
    # the heating rates divide flux differences by dp, a few Pa near the
    # model top: gated in the reference's form, as in the step phase
    heating_rate_gates(upd["dtdt"][:n].cpu(), cpu[2]["dtdt"],
                       inp.ple[:n].cpu(), cpu[2]["sw"]["fsw"],
                       cpu[2]["lw"]["flw"], 5e-5, 5e-5)
    check_physical(torch, sol, irr, upd, (120.0, 340.0))
    del cpu, states_c, upd
    replay_vs_eager(torch, "chou refresh", refresh, eager_refresh,
                    (DOY, DOY + 0.001))
    sync_free_gate(torch, "chou refresh replayed", refresh)
    sync_free_gate(torch, "chou refresh eager", eager_refresh)
    route_times(torch, "chou radiation_refresh", refresh, eager_refresh, 3)
    print(f"  peak device memory of one refresh: eager "
          f"{peak_mib(torch, eager_refresh):.1f} MiB, replayed "
          f"{peak_mib(torch, refresh):.1f} MiB beside the graph pool's "
          f"{pool_bytes(torch, dev) / 2**20:.1f} MiB")
    if profile:
        device_profile(torch, "Chou refresh + update, replayed",
                       lambda: update(refresh()), 1, top=10)
        device_profile(torch, "Chou refresh + update, eager",
                       lambda: update(eager_refresh()), 1, top=10)
    drop_graphs(torch, dev, cfg)


def rrtmgp_phase(torch, step, draw, profile=False):
    """The RRTMGP facade at full width through the captured
    radiation_refresh + radiation_update: K3, K4, K5 and K10 once each
    per replay and K8 twice, K3-K5 each held to its twin on the inputs the
    eager body (op_by_op) gives it, K8 bitwise on both of its calls'
    (mcica_gmr_result; draw: one threefry draw's instructions by class)
    and K10 at the SW kernel gates on its call's (rte_sw_result);
    the replays bitwise equal to the eager body at two doy values; the
    refresh against plain=True on the card; physics; replay and eager
    body sync-free; both routes' times, the first call, the pool and the
    peak memory (with profile, where its time goes). Returns the launches
    of the captured run, K8's result and K10's."""
    from geosradiation_gridcomp_tpu_torch.config import (RadiationConfig,
                                                         Scheme)
    from geosradiation_gridcomp_tpu_torch.driver.astronomy import \
        mean_cos_zenith
    from geosradiation_gridcomp_tpu_torch.driver.step import (
        radiation_refresh, radiation_refresh_eager, radiation_update)
    from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.rtrnmc import rtrnmc
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_lw import (
        NGS_LW, taumol_lw)
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.taumol_sw import (
        NGS_SW, taumol_sw)
    from geosradiation_gridcomp_tpu_torch.models.rrtmgp import kdist, rte
    from geosradiation_gridcomp_tpu_torch.models.rrtmgp import scheme

    inp, ict, icb, mods = step["inp"], step["ict"], step["icb"], step["mods"]
    dev = inp.t.device
    cfg = RadiationConfig(sw_scheme=Scheme.RRTMGP, lw_scheme=Scheme.RRTMGP)

    def refresh(doy=DOY, plain=False, entry=radiation_refresh):
        return entry(inp, doy, UTC, config=cfg, ict=ict, icb=icb,
                     plain=plain, **mods)
    eager_refresh = op_by_op(
        lambda doy=DOY: refresh(doy, entry=radiation_refresh_eager))

    def update(states):
        return radiation_update(*states, inp.tsinst + 0.5, inp.lons,
                                inp.lats, inp.ple, DOY, UTC + 0.25,
                                config=cfg)

    print(f"rrtmgp: RRTMGP facade radiation_refresh + radiation_update at "
          f"{inp.t.shape[0]} x {NLEV}:")
    LAUNCHES.clear()
    (sol, irr), first_ms, pool_mib = first_call(torch, dev, refresh)
    upd = update((sol, irr))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"  kernel launches in the rrtmgp path: {launches}")
    want = dict(dict.fromkeys(("taumol_lw", "taumol_sw", "rtrnmc",
                               "rte_sw"), 1), mcica_gmr=2, lw_rows=2)
    if launches != want:
        raise AssertionError(f"rrtmgp path launched {launches}, not {want}")
    print(f"  first call (warm-up + capture + replay) {first_ms:.1f} ms; "
          f"graph pool +{pool_mib:.1f} MiB for the key")

    # each kernel's inputs on this path, recorded on the eager body (a
    # replay calls no wrapper), to hold it to its twin
    wrapped = {"taumol_lw": (kdist, "taumol_lw_fast"),
               "taumol_sw": (kdist, "taumol_sw_fast"),
               "rtrnmc": (rte, "rtrnmc_fast"),
               "mcica_gmr": (scheme, "_gen_max_ran_mask"),
               "rte_sw": (scheme, "rte_sw_fast")}
    saved = {k: getattr(m, a) for k, (m, a) in wrapped.items()}
    calls, draw_calls = {}, {}

    def recorder(name):
        def wrapper(*args, **kwargs):
            calls.setdefault(name, (args, kwargs))
            if name == "mcica_gmr":     # SW and LW, told apart by ngpt
                draw_calls.setdefault(args[5], args[:7])
            return saved[name](*args, **kwargs)
        return wrapper
    try:
        for k, (m, a) in wrapped.items():
            setattr(m, a, recorder(k))
        eager_states = eager_refresh()
    finally:
        for k, (m, a) in wrapped.items():
            setattr(m, a, saved[k])
    del saved["mcica_gmr"], calls["mcica_gmr"], saved["rte_sw"]
    k10_call = calls.pop("rte_sw")
    gate("rrtmgp replay vs eager body: leaves not bitwise equal",
         unequal_leaves(torch, (sol, irr), eager_states), 0)
    del eager_states
    replay_vs_eager(torch, "rrtmgp refresh", refresh, eager_refresh,
                    (DOY + 0.001,))

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
    k8 = mcica_gmr_result(torch, draw_calls, draw)
    del draw_calls
    k10 = rte_sw_result(torch, *k10_call)
    del k10_call

    sol_p, irr_p = refresh(plain=True)
    ref = (sol_p, irr_p, update((sol_p, irr_p)))
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
    del ref, sol_p, irr_p
    sync_free_gate(torch, "rrtmgp refresh replayed", refresh)
    sync_free_gate(torch, "rrtmgp refresh eager", eager_refresh)

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

    route_times(torch, "rrtmgp radiation_refresh", refresh, eager_refresh,
                3)
    t_plain = walls(torch, lambda: refresh(plain=True), 1)
    print(f"  plain refresh {t_plain[0] * 1e3:.1f} ms; peak device "
          f"memory of one refresh: eager "
          f"{peak_mib(torch, eager_refresh):.1f} MiB, replayed "
          f"{peak_mib(torch, refresh):.1f} MiB beside the graph pool's "
          f"{pool_bytes(torch, dev) / 2**20:.1f} MiB")
    if profile:
        device_profile(torch, "RRTMGP refresh, replayed", refresh, 1,
                       top=12)
        device_profile(torch, "RRTMGP refresh, eager", eager_refresh, 1,
                       top=12)
    drop_graphs(torch, dev, cfg)
    return launches, k8, k10


def rte_sw_result(torch, args, kw):
    """K10 on the inputs the RRTMGP refresh's eager body gave rte_sw_fast:
    both streams' six profiles against its twin (rte_sw all-sky, then
    rte_sw with zero cloud optics) at the SW kernel gates (relmax 5e-4, at
    most 0.5 % of columns beyond 5e-5) and equal to itself over two runs;
    the route's (CUDA events), the kernel's (device) and the twin's times;
    the bound: roofline/K10.py's count (each input read once, each output
    written once; per solve K6's 7 special-function and 30 FP32
    instructions, both streams in every column)."""
    from geosradiation_gridcomp_tpu_torch.models.rrtmgp.rte_sw_cuda import \
        rte_sw_fast
    twin = on_twins(rte_sw_fast)
    taug = args[0]
    print(f"K10 (rte_sw) at {tuple(taug.shape)}, aerosol "
          f"{kw.get('tau_aer') is not None}:")

    def run():
        return rte_sw_fast(*args, **kw)
    got, again, want = run(), run(), twin(*args, **kw)
    r = dict(max_abs_err=0.0, library_ms=None)
    for sky, a, b, c in zip(("all-sky", "clear"), got, want, again):
        for k in b:
            gate(f"K10 {sky} {k} relmax", relmax(a[k], b[k]), 5e-4)
            gate(f"K10 {sky} {k} flipped columns", flipped_share(a[k], b[k]),
                 5e-3)
            gate(f"K10 {sky} {k} run to run: unequal",
                 float((a[k] != c[k]).sum()), 0)
            r["max_abs_err"] = max(r["max_abs_err"], max_abs(a[k], b[k]))
    moved = nbytes(args[:9], list(kw.values()), got)
    del got, again, want
    solves = 2 * taug.numel()
    r["ms"] = time_ms(torch, run, 20)
    r["device_ms"] = kernel_device_ms(torch, "rte_sw", run)
    if r["device_ms"] <= 0.0:
        r["device_ms"] = float("nan")
        print("  torch.profiler recorded no rte_sw_kernel: device time not "
              "measured; what it recorded:")
        device_profile(torch, "K10 call", run, 5, top=8)
    r["plain_ms"] = time_ms(torch, lambda: twin(*args, **kw), 3)
    r["bound_ms"], r["bound_by"] = bound(moved, seconds=issue_seconds(
        dict(mufu=7 * solves, fp32=30 * solves), 1))
    print(f"  route {r['ms']:.4f} ms, kernel device {r['device_ms']:.4f} ms "
          f"(plain {r['plain_ms']:.2f} ms), bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f} % of the "
          f"route)")
    return r


def mcica_gmr_result(torch, calls, draw):
    """K8 on the inputs the RRTMGP refresh's eager body gave
    _gen_max_ran_mask (calls: ngpt -> its first seven arguments), the SW's
    and the LW's: mask and zcw held bitwise to the plain twin on each, and
    the route's, the kernel's and the twin's times and the bound summed
    over the two, a refresh's draws. The bound: the threefry draws K8
    cannot skip (per g-point of a cloudy column, 4 x depth - 2, or
    2 x depth - 1 without the class table, depth reaching its lowest
    cloudy layer; 4 for its key), or reading cldf, alpha and rcorr, play's
    lowest four layers and the table, and writing the outputs."""
    from geosradiation_gridcomp_tpu_torch.models.rrtmgp.scheme import \
        _gen_max_ran_mask
    twin = on_twins(_gen_max_ran_mask)

    r = dict(max_abs_err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0,
             library_ms=None)
    moved = work = 0
    for ng in sorted(calls):
        args = calls[ng]
        cldf, cond = args[4], args[6] is not None
        print(f"K8 (mcica_gmr) at {tuple(cldf.shape)} x {ng}:")
        got = _gen_max_ran_mask(*args)
        want = twin(*args)
        for name, a, b in zip(("cld_mask", "zcw"), got, want):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"K8 {name}: {a.dtype}{tuple(a.shape)}"
                                     f" against {b.dtype}{tuple(b.shape)}")
            gate(f"K8 {name} vs its twin: unequal", float((a != b).sum()),
                 0)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("K8 is not bitwise equal to its twin")
        moved += nbytes(got) + 3 * nbytes(cldf) + 16 * cldf.shape[0] + (
            nbytes(args[6]) if cond else 0)
        del got, want
        cloudy = cldf > 0.0
        cols = cloudy.any(dim=1)
        depth = cldf.shape[1] - cloudy.flip(1).int().argmax(dim=1)
        per_layer = 4 if cond else 2
        work += ng * int((per_layer * depth - per_layer // 2)[cols].sum()) \
            + 4 * int(cols.sum())
        run = lambda: _gen_max_ran_mask(*args)
        ms = time_ms(torch, run, 20)
        dev_ms = kernel_device_ms(torch, "mcica_gmr", run)
        plain_ms = time_ms(torch, lambda: twin(*args), 2)
        print(f"  route {ms:.4f} ms (overlap parameters included), kernel "
              f"device {dev_ms:.4f} ms (plain {plain_ms:.2f} ms)")
        r["ms"] += ms
        r["device_ms"] += dev_ms
        r["plain_ms"] += plain_ms
    r["bound_ms"], r["bound_by"] = bound(
        moved, seconds=issue_seconds(draw_counts(draw, work), 1))
    print(f"  K8 a refresh (SW + LW): route {r['ms']:.4f} ms, device "
          f"{r['device_ms']:.4f} ms (plain {r['plain_ms']:.1f} ms), bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']} ("
          f"{100 * r['bound_ms'] / r['device_ms']:.1f} % of it)")
    return r


def rrtmgp_native_phase(torch, step, profile=False):
    """RRTMGP through the native engine (an ingested coefficient set: the
    synthetic one, written to build/) at full width through the captured
    radiation_refresh + radiation_update, where K8 alone may launch, twice;
    against the same functions on the CPU on the first 256 columns; the
    replays bitwise equal to the eager body (op_by_op) at two doy values;
    replay and eager body sync-free; both routes' times, the first call,
    the pool and the peak memory (with profile, where its time goes)."""
    import os

    from geosradiation_gridcomp_tpu_torch.config import (RadiationConfig,
                                                         Scheme)
    from geosradiation_gridcomp_tpu_torch.driver.astronomy import \
        mean_cos_zenith
    from geosradiation_gridcomp_tpu_torch.driver.radiation import \
        AtmosInputs
    from geosradiation_gridcomp_tpu_torch.driver.step import (
        radiation_refresh, radiation_refresh_eager, radiation_update)
    from geosradiation_gridcomp_tpu_torch.kernels.build import (BUILD_DIR,
                                                                LAUNCHES)
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.lw import RRTMGLW
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.sw import RRTMGSW

    inp, ict, icb, mods = step["inp"], step["ict"], step["icb"], step["mods"]
    dev = inp.t.device
    paths = [os.path.join(os.path.dirname(BUILD_DIR),
                          f"rrtmgp_kdist_{b}.npz") for b in ("lw", "sw")]
    os.makedirs(os.path.dirname(BUILD_DIR), exist_ok=True)
    for p in paths:
        save_kdist_npz(synthetic_kdist(), p)
    cfg = RadiationConfig(sw_scheme=Scheme.RRTMGP, lw_scheme=Scheme.RRTMGP,
                          rrtmgp_kdist_lw=paths[0], rrtmgp_kdist_sw=paths[1],
                          outputs=frozenset({"olrb"}))

    def refresh(doy=DOY, x=inp, m=mods, entry=radiation_refresh):
        return entry(x, doy, UTC, config=cfg, ict=ict, icb=icb, **m)
    eager_refresh = op_by_op(
        lambda doy=DOY: refresh(doy, entry=radiation_refresh_eager))

    def update(states, x=inp):
        return radiation_update(*states, x.tsinst + 0.5, x.lons, x.lats,
                                x.ple, DOY, UTC + 0.25, config=cfg)

    print(f"rrtmgp_native: RRTMGP native engine (synthetic 2-band set, "
          f"{paths[0]}) radiation_refresh + radiation_update at "
          f"{inp.t.shape[0]} x {NLEV}:")
    LAUNCHES.clear()
    (sol, irr), first_ms, pool_mib = first_call(torch, dev, refresh)
    upd = update((sol, irr))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"  kernel launches in the rrtmgp_native path: {launches}")
    if launches != {"mcica_gmr": 2, "lw_rows": 1}:
        raise AssertionError(f"the native path launched {launches}")
    print(f"  first call (warm-up + capture + replay) {first_ms:.1f} ms; "
          f"graph pool +{pool_mib:.1f} MiB for the key")
    if tuple(irr.olrb.shape) != (inp.t.shape[0], 2):
        raise AssertionError(f"olrb has shape {tuple(irr.olrb.shape)}, not "
                             f"({inp.t.shape[0]}, 2)")
    n = 256
    head = AtmosInputs(*(x[:n].cpu() for x in inp))
    cpu_mods = dict(sw=RRTMGSW.from_reference_tables("cpu"),
                    lw=RRTMGLW.from_reference_tables("cpu"))
    states_c = refresh(x=head, m=cpu_mods)
    cpu = (*states_c, update(states_c, head))
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
    del cpu, states_c
    replay_vs_eager(torch, "native refresh", refresh, eager_refresh,
                    (DOY, DOY + 0.001))
    sync_free_gate(torch, "native refresh replayed", refresh)
    sync_free_gate(torch, "native refresh eager", eager_refresh)
    route_times(torch, "native radiation_refresh", refresh, eager_refresh,
                3)
    print(f"  peak device memory of one refresh: eager "
          f"{peak_mib(torch, eager_refresh):.1f} MiB, replayed "
          f"{peak_mib(torch, refresh):.1f} MiB beside the graph pool's "
          f"{pool_bytes(torch, dev) / 2**20:.1f} MiB")
    if profile:
        device_profile(torch, "native RRTMGP refresh + update, replayed",
                       lambda: update(refresh()), 1, top=10)
        device_profile(torch, "native RRTMGP refresh + update, eager",
                       lambda: update(eager_refresh()), 1, top=10)
    drop_graphs(torch, dev, cfg)
    return launches


def driver_phase(torch, step, profile=False):
    """The clock-driven model loop at full width with the kernels, then
    the same run restarted from a checkpoint after heartbeat 2; the
    alarm's radiation_refresh + rats_refresh replayed bitwise equal to the
    eager bodies (op_by_op) and sync-free, with both routes' times (with
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

    def alarm(doy, utc, nlit, ncld):
        """The refresh alarm's device work: the step refresh and RATS."""
        sol, irr = radiation_refresh(inp, doy, utc, config=cfg, ict=ict,
                                     icb=icb, sw_nlit=nlit, sw_ncld=ncld,
                                     **mods)
        return sol, irr, rats_refresh(inp, doy, cfg, ict, icb,
                                      lw=mods["lw"])

    def refresh(clk):
        validate_inputs(inp)
        nlit, ncld = sw_partition_bounds(inp.lons, inp.lats, inp.fcld,
                                         clk.doy, clk.utc_hours, cfg)
        states = alarm(clk.doy, clk.utc_hours, nlit, ncld)
        for name, st in zip(("SolarState", "IrradState", "RatsState"),
                            states):
            check_finite(st, name)
        return states

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
    bounds = sw_partition_bounds(inp.lons, inp.lats, inp.fcld, DOY, UTC, cfg)
    captured = lambda doy=DOY: alarm(doy, UTC, *bounds)
    eager_alarm = op_by_op(captured)
    replay_vs_eager(torch, "refresh alarm (radiation_refresh + "
                    "rats_refresh)", captured, eager_alarm,
                    (DOY, DOY + 0.001))
    sync_free_gate(torch, "refresh alarm replayed", captured)
    sync_free_gate(torch, "refresh alarm eager", eager_alarm)
    route_times(torch, "refresh alarm (radiation_refresh + rats_refresh)",
                captured, eager_alarm, 5)
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
    """The COSP satellite simulators at full width on the card through the
    captured cosp_simulator, no kernel launched: the first call and the
    graph pool's growth; every group and key, finite or a fill value,
    within the reference tests' ranges; against the same call on the CPU
    on 256 points; the replays bitwise equal to the eager body
    (op_by_op) at keys 11 and 12; replay and eager body sync-free; both
    routes' times and peak memory beside the pool's; the radar alone on
    the arguments of an eager call (with profile, where each route's
    time goes and its idle share); then the phase's graphs are
    dropped."""
    from geosradiation_gridcomp_tpu_torch.driver import compiled
    from geosradiation_gridcomp_tpu_torch.kernels.build import LAUNCHES
    from geosradiation_gridcomp_tpu_torch.ops import threefry
    from geosradiation_gridcomp_tpu_torch.satsim import (SatsimConfig,
                                                         SatsimInputs,
                                                         cosp, prec_scops)

    cfg = SatsimConfig()
    inp = satsim_inputs(torch, NCOL_SLICE, dev)
    keys = {seed: threefry.key(seed, device=dev) for seed in (11, 12)}

    def run(seed=11, x=inp):
        return cosp.cosp_simulator(keys[seed] if x.t.is_cuda
                                   else keys[seed].cpu(), x, cfg)
    eager_run = op_by_op(run)

    print(f"satsim: cosp_simulator (SatsimConfig(): {cfg.ncolumns} "
          f"subcolumns, every simulator, the {cfg.nlr}-bin stat grid) at "
          f"{NCOL_SLICE} points x {NLEV} levels, key 11:")
    # the key captures into a pool of its own, so that the pool's growth
    # is the key's need (in the shared pool it fits in the blocks the
    # dropped Chou and RRTMGP keys left free); later captures take the
    # shared pool again. A pool whose graphs are all dropped takes no
    # new capture while a block allocated in it lives (PyTorch's
    # allocator asserts), so this one is used for this key alone.
    own = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev))
    shared, compiled.graph_pool = compiled.graph_pool, lambda device: own
    try:
        LAUNCHES.clear()
        out, first_ms, pool_mib = first_call(torch, dev, run)
    finally:
        compiled.graph_pool = shared
    launches = dict(LAUNCHES)
    print(f"  kernel launches in the satsim path: {launches}")
    if launches:
        raise AssertionError(f"the satsim path launched {launches}")
    print(f"  first call (warm-up + capture + replay) {first_ms:.1f} ms; "
          f"graph pool +{pool_mib:.1f} MiB for the key")
    satsim_checks(torch, out, cfg, NCOL_SLICE)
    del out

    n = 256
    head = SatsimInputs(*(x[:n] for x in inp))
    print(f"  card vs CPU on the first {n} points (their own call, key 11):")
    card = run(x=head)
    cpu_in = SatsimInputs(*(x.cpu() for x in head))
    t0 = time.perf_counter()
    cpu = run(x=cpu_in)
    t_cpu = time.perf_counter() - t0
    pf = [prec_scops(x.qr + x.qs + x.qg, torch.zeros_like(x.qr),
                     o["frac_out"]) for x, o in ((head, card),
                                                 (cpu_in, cpu))]
    gate("prec_frac mismatches", float((pf[0].cpu() != pf[1]).sum()), 0)
    flips, total = satsim_compare(torch, card, cpu, cfg.ncolumns)
    del card, cpu, pf
    print(f"  the CPU call on {n} points {t_cpu:.1f} s")

    replay_vs_eager(torch, "cosp_simulator", run, eager_run, (11, 12),
                    what="key")
    sync_free_gate(torch, "cosp_simulator replayed", run)
    sync_free_gate(torch, "cosp_simulator eager", eager_run)
    times = route_times(torch, "cosp_simulator", run, eager_run, 3)
    print(f"  peak device memory of one cosp_simulator: eager "
          f"{peak_mib(torch, eager_run):.1f} MiB, replayed "
          f"{peak_mib(torch, run):.1f} MiB beside the key's graph pool's "
          f"{pool_bytes(torch, dev, own[0]) / 2**20:.1f} MiB")
    # the radar's inputs, recorded on the eager body (a replay calls no
    # Python function), to time it alone
    qb, qb_calls = cosp.quickbeam_simulator, []

    def qb_recorded(*args, **kwargs):
        qb_calls.append((args, kwargs))
        return qb(*args, **kwargs)
    cosp.quickbeam_simulator = qb_recorded
    try:
        eager_run()
    finally:
        cosp.quickbeam_simulator = qb
    (args, kw), = qb_calls
    radar = time_ms(torch, lambda: qb(*args, **kw), 3)
    ev = {k: statistics.mean(v[1]) for k, v in times.items()}
    print(f"  quickbeam_simulator alone ({len(kw['classes'])} classes "
          f"{kw['classes']}) {radar:.1f} ms by CUDA events (mean of 3): "
          f"{100 * radar / ev['eager']:.1f} % of the eager call, "
          f"{100 * radar / ev['captured']:.1f} % of the replay")
    del qb_calls, args, kw
    if profile:
        device_profile(torch, "cosp_simulator, replayed", run, 1, top=12)
        device_profile(torch, "cosp_simulator, eager", eager_run, 1, top=12)
    drop_graphs(torch, dev, cfg, (cosp.cosp_simulator,))
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
    copies from pinned memory (the staged inputs) and the kernels ran,
    how many other host-to-device copies there were (the captured
    refresh makes none), and how much of the pinned copies' time
    overlapped a kernel of another stream."""
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
          f"{len(htod) - len(staged)} of them from pageable memory, "
          f"{len(staged)} from pinned memory "
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
    return [r[2] for r in rows]


def profile_phase(torch, step, nwall=30, nprof=5):
    """--profile: where the time of the full-width refresh goes."""
    from geosradiation_gridcomp_tpu_torch.driver import radiation as rad
    from geosradiation_gridcomp_tpu_torch.driver.astronomy import \
        mean_cos_zenith
    from geosradiation_gridcomp_tpu_torch.models.rrtmg.sw import \
        SEED_ORDER_SW
    from geosradiation_gridcomp_tpu_torch.ops import mcica

    refresh, update = step["refresh"], step["update"]
    inp, cfg, nlit = step["inp"], step["cfg"], step["nlit"]
    states = refresh()
    for route, eager in (("eager", True), ("captured", False)):
        print(f"profile: {route} radiation_refresh at {NCOL_SLICE} x {NLEV}:")
        times = walls(torch, lambda: refresh(eager=eager), nwall)
        q = statistics.quantiles(times, n=4)
        print(f"  wall over {nwall}: median "
              f"{statistics.median(times) * 1e3:.3f} ms, quartiles "
              f"{q[0] * 1e3:.3f} / {q[2] * 1e3:.3f}, min "
              f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}; CUDA "
              f"events {time_ms(torch, lambda: refresh(eager=eager), 10):.3f}"
              f" ms (mean of 10)")
        names = device_profile(torch, f"{route} refresh",
                               lambda: refresh(eager=eager), nprof)
        device_profile(torch, f"{route} update",
                       lambda: update(states, eager=eager), nprof, top=5)
    missing = [k for k, v in SOURCES.items() if v[2] == "step"
               and not any(v[3] in n for n in names)]
    print(f"  step kernels the profiler names inside the replay: "
          f"{'all' if not missing else f'all but {missing}'}")

    # K1 and K2 derive the subkeys and K2 the SW band optics on the card:
    # the refresh calls neither subcolumn_keys nor band_optics_coeffs_sw
    # (the plain twins do)
    found = off_kernel_path_calls(lambda: refresh(eager=True))
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
        solar_refresh=op_by_op(lambda: rad.solar_refresh(
            inp, zth, DOY, cfg, step["ict"], step["icb"], nlit=nlit,
            ncld=step["ncld"], sw=step["mods"]["sw"])),
        irrad_refresh=op_by_op(lambda: rad.irrad_refresh(
            inp, DOY, cfg, step["ict"], step["icb"], lw=step["mods"]["lw"])),
        subcolumn_keys_lw_off_kernel_path=lambda: mcica.subcolumn_keys(play),
        subcolumn_keys_sw_off_kernel_path=lambda: mcica.subcolumn_keys(
            play[:nlit], SEED_ORDER_SW))
    for name, fn in stages.items():
        print(f"  {name} alone, op by op: {time_ms(torch, fn, 10):.3f} ms "
              f"(CUDA events, mean of 10)")


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
# it: step, verify, profiling or rrtmgp, its CUDA function's name)
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
    # K8 replaces plain jnp code, not a Pallas kernel
    "mcica_gmr": (_CSRC + "mcica_gmr.cu",
                  _REF + "models/rrtmgp/scheme.py:93", "rrtmgp",
                  "mcica_gmr_kernel"),
    # K9 replaces plain jnp code too: the LW cloud rows and Planck rows
    "lw_rows": (_CSRC + "lw_rows.cu",
                _REF + "models/rrtmg/cldprmc_lw.py:54, "
                "models/rrtmg/setcoef_lw.py:61", "step", "lw_rows_kernel"),
    # K10 too: RRTMGP's SW solver, both streams
    "rte_sw": (_CSRC + "rte_sw.cu", _REF + "models/rrtmgp/rte.py:20",
               "rrtmgp", "rte_sw_kernel"),
}
# launches a step refresh makes of each step kernel: one, but K9's two
# (the cloud rows and the Planck rows of the LW solve)
PER_REFRESH = {"lw_rows": 2}


def per_refresh(name):
    return PER_REFRESH.get(name, 1)


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
    timed("sync-free", sync_free_phase, torch, calls, step)
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
    paths["rrtmgp"], results["mcica_gmr"], results["rte_sw"] = timed(
        "rrtmgp", rrtmgp_phase, torch, step, draw, args.profile)
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
            launches_per_refresh=paths[path][name]
            if path in ("step", "rrtmgp") else 0,
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
