"""Time the step kernels (K1-K6) of one checkout on the refresh's own
inputs, or P2's gather_rows (--p2), for an A/B of two checkouts on one
card.

    python geosradiation_gridcomp_tpu_torch/tools/profiling/kernel_ab.py \
        [--tree PATH] [--label NAME] [--rounds 5] [--k 20] [--p2]

Run as a file, not with -m: --tree names the root of the checkout whose
package `geosradiation_gridcomp_tpu_torch` is timed (default: the checkout
holding this file), so an unpacked archive of another commit is timed with
this same script. Run parent, change, change, parent in one call and
compare within it.

The inputs are those of one radiation_refresh at 8192 columns x 72
levels on the scene of scene.example_inputs (seed 0), doy 172, 12 UTC,
with bench.py's sw_partition_bounds packing: each step kernel's wrapper
is recorded as the refresh calls it (`recording`, which chip_smoke.py
uses too). Each of the six is then timed with CUDA events, the median
of --rounds rounds of --k back-to-back calls, held once against its
plain twin (relmax, max|a - b| / max|b|, worst output), called once
under torch.cuda.set_sync_debug_mode("error") (`sync_free`: true, or the
error a synchronising call raised), and profiled over 5 calls
(torch.profiler: `kernel_ms`, the device time of the CUDA kernel itself
per call, and `other_device_ms`, that of everything else the wrapper
runs on the device: copies, PyTorch's own kernels).

Two McICA stages are timed as a whole, so that checkouts whose K1 and K2
take different inputs compare: `lw_mcica_stage` and `sw_mcica_stage`,
the scheme's McICA kernel with whatever the scheme runs to feed it (a
checkout whose K1/K2 take threefry subkeys and band planes derives them
first, with ops.mcica.subcolumn_keys and band_optics_coeffs_sw + a
stack; one whose kernels take play, rei and rel runs the kernel alone):
`ms` (CUDA events, as above), `device_ms` and `launches` per call
(torch.profiler). `refresh` is the whole radiation_refresh: `wall_ms`,
the median of --rounds x --k refreshes each timed on the host clock
between two synchronisations, and `device_ms`, `launches` and the `top`
device kernels (name, ms, launches) per refresh (torch.profiler over 5).

With --p2 nothing of that runs: `gather_rows` is timed at the gather
tool's 8192 x 72 points on a 585 x 16 table (seed 0) and at the
refresh's LW cloud-table gathers (`lw_cloud_gathers`: absice3 and
absliq1 at rows index - 1 and index of [8192, 72] indices, as
band_abs_coeffs_lw forms them on scene.example_inputs). Each gives `ms`,
CUDA events around calls that keep their last LIVE outputs alive
(`rotating`: the writes of consecutive calls then exceed the 50 MB L2),
`ms_cached` (outputs dropped at once, so the allocator hands back the
same block), `kernel_ms` and `other_device_ms` (torch.profiler, rotated
calls), `host_ms` (the host's time to enqueue a call), the
vector width of the instance that ran (`vec`; null where the checkout's
wrapper does not say), whether it equals the plain twin exactly, and the
same rotated time of `tab[idx]` and of `torch.index_select(tab, 0, idx)`
(int64 indices, as the refresh gathers), with the device time and the
top device kernels of `tab[idx]` (torch.profiler).

Prints the card's name and power limit, then one JSON line.
"""

import argparse
import contextlib
import importlib
import json
import os
import statistics
import subprocess
import sys

NCOL, NLEV, SEED, DOY, UTC = 8192, 72, 0, 172.0, 12.0
HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = "geosradiation_gridcomp_tpu_torch"

# the step kernels: name -> (scheme module that calls the wrapper, the
# wrapper's name there, the plain twin as module:function, the CUDA
# kernel's function name in csrc/)
STEP_KERNELS = {
    "mcica_optics_lw": ("lw", "mcica_optics_lw",
                        "ops.mcica_cuda:mcica_optics_lw_plain",
                        "mcica_lw_kernel"),
    "taumol_lw": ("lw", "taumol_lw_fast", "models.rrtmg.taumol_lw:taumol_lw",
                  "taumol_lw_kernel"),
    "rtrnmc": ("lw", "rtrnmc_fast", "models.rrtmg.rtrnmc:rtrnmc",
               "rtrnmc_kernel"),
    "mcica_optics_sw": ("sw", "mcica_optics_sw",
                        "ops.mcica_cuda:mcica_optics_sw_plain",
                        "mcica_sw_kernel"),
    "taumol_sw": ("sw", "taumol_sw_fast", "models.rrtmg.taumol_sw:taumol_sw",
                  "taumol_sw_kernel"),
    "spcvmc": ("sw", "spcvmc_fast", "models.rrtmg.spcvmc:spcvmc_sw",
               "spcvmc_kernel"),
}


# what a scheme module may call to feed its McICA kernel: recorded as
# "<module>.<function>" where the module has it
STAGE_HELPERS = {"lw": ("subcolumn_keys",),
                 "sw": ("subcolumn_keys", "band_optics_coeffs_sw")}


def plain_twin(name):
    """The plain PyTorch twin of step kernel `name`."""
    mod, fn = STEP_KERNELS[name][2].split(":")
    return getattr(importlib.import_module(f"{_PKG}.{mod}"), fn)


@contextlib.contextmanager
def recording():
    """Within the block, each step kernel's wrapper, as the scheme modules
    (models/rrtmg/lw.py, sw.py) call it, keeps the arguments of its first
    call: yields kernel name -> (wrapper, args, kwargs). So does each
    STAGE_HELPERS function a scheme module has, as "<module>.<name>"."""
    modules = {m: importlib.import_module(f"{_PKG}.models.rrtmg.{m}")
               for m in ("lw", "sw")}
    calls = {}

    def wrap(fn, name):
        def wrapper(*args, **kwargs):
            calls.setdefault(name, (fn, args, kwargs))
            return fn(*args, **kwargs)
        return wrapper
    saved = {}
    targets = [(name, m, attr) for name, (m, attr, *_) in
               STEP_KERNELS.items()]
    targets += [(f"{m}.{attr}", m, attr) for m, attrs in STAGE_HELPERS.items()
                for attr in attrs if hasattr(modules[m], attr)]
    for name, m, attr in targets:
        saved[m, attr] = getattr(modules[m], attr)
        setattr(modules[m], attr, wrap(saved[m, attr], name))
    try:
        yield calls
    finally:
        for (m, attr), fn in saved.items():
            setattr(modules[m], attr, fn)


def tensors(out):
    """The tensors of a kernel's output (a tensor, tuple or dict), in
    order."""
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in tensors(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in tensors(x)]
    return [out] if hasattr(out, "shape") else []


def relmax(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-6))


def median_ms(torch, fn, k, rounds):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k)
    return statistics.median(times)


def host_ms(torch, fn, k, rounds):
    """Median host time per call of fn when the host does not wait for the
    card (k calls between two host-clock reads, after a synchronize): the
    cost of enqueuing it, which bounds back-to-back calls from below."""
    import time
    fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        times.append(1e3 * (time.perf_counter() - t0) / k)
    torch.cuda.synchronize()
    return statistics.median(times)


def sync_free(torch, run):
    """True if run() makes no call that synchronises the stream, else the
    error torch raised."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
        return True
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def device_ms(torch, run, kernel, n=5):
    """(kernel's, everything else's) device time per call of run(), ms,
    from torch.profiler over n calls; kernel: the CUDA function's name."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    mine = other = 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            if kernel in e.key:
                mine += e.device_time_total
            else:
                other += e.device_time_total
    return mine / 1e3 / n, other / 1e3 / n


def mcica_stage(torch, calls, m):
    """Scheme m's ("lw" or "sw") McICA stage on the recorded inputs, as
    one callable: its kernel's wrapper, fed as the scheme fed it."""
    fn, a, kw = calls["mcica_optics_lw" if m == "lw" else "mcica_optics_sw"]
    if f"{m}.subcolumn_keys" not in calls:
        return lambda: fn(*a, **kw)
    keys, ka, kkw = calls[f"{m}.subcolumn_keys"]
    if m == "lw":
        return lambda: fn(keys(*ka, **kkw), *a[1:], **kw)
    planes, pa, pkw = calls["sw.band_optics_coeffs_sw"]
    return lambda: fn(keys(*ka, **kkw), *a[1:7],
                      torch.stack(planes(*pa, **pkw)), *a[8:], **kw)


def profile_per_call(torch, run, n=5, top=0):
    """(device ms, device launches) per call of run(), torch.profiler
    over n calls; with top > 0 also the top device kernels by time, as
    [name, ms, launches] per call."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and e.device_time_total > 0]
    totals = (sum(e.device_time_total for e in rows) / 1e3 / n,
              sum(e.count for e in rows) / n)
    if not top:
        return totals
    rows.sort(key=lambda e: -e.device_time_total)
    return totals + ([[e.key[:90], e.device_time_total / 1e3 / n,
                       e.count / n] for e in rows[:top]],)


LIVE = 4   # outputs a rotated timing keeps alive


def rotating(fn, live=LIVE):
    """fn as a callable that keeps its last `live` outputs alive, so that
    each call writes to memory the L2 no longer holds."""
    ring = [None] * live
    calls = [0]

    def run():
        ring[calls[0] % live] = fn()
        calls[0] += 1
    return run


def lw_cloud_gathers(torch, dev):
    """The refresh's LW table-row gathers: name -> (table, int64 index
    [NCOL, NLEV]) for the rows index - 1 and index of absice3 and absliq1,
    recorded from band_abs_coeffs_lw on scene.example_inputs' radii (the
    refresh passes inp.ri and inp.rl to it unchanged)."""
    from geosradiation_gridcomp_tpu_torch.models.rrtmg import cldprmc_lw
    from geosradiation_gridcomp_tpu_torch.scene import example_inputs
    inp = example_inputs(NCOL, NLEV, seed=SEED, device=dev)
    tables = cldprmc_lw.lw_cloud_tables(dev)
    seen = []
    interp = cldprmc_lw._interp_rows

    def record(tab, index, fint):
        seen.append((tab, index))
        return interp(tab, index, fint)
    cldprmc_lw._interp_rows = record
    try:
        cldprmc_lw.band_abs_coeffs_lw(inp.ri, inp.rl, tables)
    finally:
        cldprmc_lw._interp_rows = interp
    out = {}
    for name, (tab, index) in zip(("absice3", "absliq1"), seen):
        assert tab is tables[name]
        out[f"{name} index-1"] = (tab, index - 1)
        out[f"{name} index"] = (tab, index)
    return out


def p2_case(torch, gather_cuda, tab, idx64, k, rounds):
    """gather_rows on tab at idx64 (int64, any shape): exact against the
    twin, its rotated and cached CUDA-event ms, its kernel's device ms
    (and the rest's) and vector width, and the library calls' rotated
    ms."""
    idx = idx64.reshape(-1).int()
    flat = idx64.reshape(-1)
    run = lambda: gather_cuda.gather_rows(idx, tab)
    out = run()
    vec = getattr(gather_cuda, "rows_vec", None)
    res = dict(points=idx.numel(), table=list(tab.shape),
               vec=vec(tab, out) if vec else None,
               exact=bool(torch.equal(out, tab[flat])),
               ms=median_ms(torch, rotating(run), k, rounds),
               ms_cached=median_ms(torch, run, k, rounds))
    res["kernel_ms"], res["other_device_ms"] = device_ms(
        torch, rotating(run), "gather_rows_kernel")
    res["host_ms"] = host_ms(torch, rotating(run), k, rounds)
    res["tab_idx_ms"] = median_ms(torch, rotating(lambda: tab[flat]), k,
                                  rounds)
    (res["tab_idx_device_ms"], _,
     res["tab_idx_kernels"]) = profile_per_call(
        torch, rotating(lambda: tab[flat]), top=2)
    res["index_select_ms"] = median_ms(
        torch, rotating(lambda: torch.index_select(tab, 0, flat)), k, rounds)
    return res


def p2_main(torch, dev, args):
    """--p2: gather_rows at the tool's shape and at the refresh's LW
    cloud-table gathers."""
    from geosradiation_gridcomp_tpu_torch.ops import gather_cuda
    gen = torch.Generator(dev).manual_seed(SEED)
    tab = torch.randn(585, 16, device=dev, generator=gen)
    idx = torch.randint(0, 585, (NCOL * NLEV,), device=dev, generator=gen)
    out = {"tool 585x16": p2_case(torch, gather_cuda, tab, idx, args.k,
                                  args.rounds)}
    for name, (t, i) in lw_cloud_gathers(torch, dev).items():
        out[name] = p2_case(torch, gather_cuda, t, i, args.k, args.rounds)
    return out


def wall_ms(torch, run, k, rounds):
    """Median host-clock time of run() between two synchronisations, over
    k x rounds runs after a warm-up, ms."""
    import time
    run()
    times = []
    for _ in range(k * rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(HERE))))
    parser.add_argument("--label", default="")
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--k", type=int, default=20)
    parser.add_argument("--p2", action="store_true",
                        help="time P2's gather_rows only")
    args = parser.parse_args(argv)
    # import the package from --tree, not this file's directory
    sys.path[:] = [os.path.abspath(args.tree)] + [
        p for p in sys.path if os.path.abspath(p or ".") != HERE]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    from geosradiation_gridcomp_tpu_torch.config import RadiationConfig
    from geosradiation_gridcomp_tpu_torch.driver.step import (
        radiation_refresh, sw_partition_bounds)
    from geosradiation_gridcomp_tpu_torch.kernels import build
    from geosradiation_gridcomp_tpu_torch.models.rrtmg import lw as lwm
    from geosradiation_gridcomp_tpu_torch.models.rrtmg import sw as swm
    from geosradiation_gridcomp_tpu_torch.scene import example_inputs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    build.library()
    dev = torch.device("cuda", 0)
    if args.p2:
        print(json.dumps(dict(label=args.label, card=smi.splitlines()[0],
                              gather_rows=p2_main(torch, dev, args))))
        return
    inp = example_inputs(NCOL, NLEV, seed=SEED, device=dev)
    cfg = RadiationConfig()
    ple0 = inp.ple[0].cpu().numpy()
    ict, icb = cfg.superlayer_indices(0.5 * (ple0[1:] + ple0[:-1]))
    bounds = [sw_partition_bounds(inp.lons, inp.lats, inp.fcld, d, UTC, cfg)
              for d in (DOY, DOY + 0.01)]
    nlit, ncld = (None if any(b[i] is None for b in bounds)
                  else max(b[i] for b in bounds) for i in (0, 1))
    mods = dict(sw=swm.RRTMGSW.from_reference_tables(dev),
                lw=lwm.RRTMGLW.from_reference_tables(dev))

    def refresh():
        return radiation_refresh(inp, DOY, UTC, config=cfg, ict=ict,
                                 icb=icb, sw_nlit=nlit, sw_ncld=ncld, **mods)
    with recording() as calls:
        refresh()
        torch.cuda.synchronize()

    out = dict(label=args.label, card=smi.splitlines()[0])
    for name in STEP_KERNELS:
        fn, a, kw = calls[name]
        run = lambda: fn(*a, **kw)
        got, want = tensors(run()), tensors(plain_twin(name)(*a, **kw))
        out[name] = dict(
            out_shape=list(got[0].shape), ncld=kw.get("ncld"),
            relmax=max(relmax(x, y) for x, y in zip(got, want)),
            ms=median_ms(torch, run, args.k, args.rounds),
            sync_free=sync_free(torch, run))
        out[name]["kernel_ms"], out[name]["other_device_ms"] = device_ms(
            torch, run, STEP_KERNELS[name][3])
    for m in ("lw", "sw"):
        run = mcica_stage(torch, calls, m)
        out[f"{m}_mcica_stage"] = dict(ms=median_ms(torch, run, args.k,
                                                    args.rounds))
        (out[f"{m}_mcica_stage"]["device_ms"],
         out[f"{m}_mcica_stage"]["launches"]) = profile_per_call(torch, run)
    out["refresh"] = dict(wall_ms=wall_ms(torch, refresh, args.k,
                                          args.rounds))
    (out["refresh"]["device_ms"], out["refresh"]["launches"],
     out["refresh"]["top"]) = profile_per_call(torch, refresh, top=12)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
