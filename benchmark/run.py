"""Run one cell of the benchmark of the port (the PyTorch and CUDA package
`geosradiation_gridcomp_tpu_torch`) once, on the CUDA card it finds:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up builds the cell's scene from the seed, its configuration and
loop, and warms up (the captured entries capture their graphs); then the
loop runs for `--seconds` with no capture inside; then the answers it
sampled are compared with the plain reference. The last line of standard
output is one JSON object: correct, attempted, failed, metrics (the
cell's end-to-end metrics, or with --trace 1 its per-layer ones, read
from a profiled stretch of the window), device, with --trace 1
breakdown, and last the numbers compared beside their limits, which are
also the last lines of standard error. Without a card, or with a module
of jax, jaxlib, flax or the JAX package loaded, it prints no result and
exits with another code than 0.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache at a fixed path inside the checkout (the
# port's own kernel library goes to build/torch_kernels/ of the checkout)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
sys.path.insert(0, ROOT)

from types import SimpleNamespace  # noqa: E402

import harness  # noqa: E402
from harness import BenchmarkError  # noqa: E402

GIB = 2.0 ** 30


def graph_pool_bytes(torch):
    """Bytes the caching allocator holds in private pools: the captured
    graphs' pool of driver/compiled.py:graph_pool, the only one."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def device_info(torch, count, device):
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def per_layer_context(cell, loop, stretch, spans, pool_bytes):
    """What the per-layer readers read: the profiled stretch's trace, the
    refresh and update windows in it, the shapes of its refreshes, the
    benchmark's spans outside it, the port's kernel names, the pool."""
    import importlib
    from roofline.peaks import least_seconds
    import program
    trace = stretch.trace
    shapes = [program.refresh_shapes(loop.arrays, cell.config, d, u)
              for d, u in loop.refresh_units(stretch.first, stretch.count)]

    def bound(stage):
        mod = importlib.import_module(f"roofline.{stage}")
        return sum(least_seconds(mod.count(s)) for s in shapes)
    return SimpleNamespace(
        trace=trace, units=stretch.count, shapes=shapes, bound=bound,
        refresh_windows=harness.unit_windows(trace, "refresh"),
        update_windows=harness.unit_windows(trace, "update"),
        spans=spans, port_kernels=harness.port_kernel_names(cell.root),
        pool_bytes=pool_bytes, unit_times=loop.window.get("times"),
        profiled=range(stretch.first, stretch.first + stretch.count))


def within(reading, limits):
    """Every number compared has a limit and lies within it (a missing
    number, a missing limit or a NaN fails)."""
    return set(reading) == set(limits) and all(
        reading[k] <= limits[k] for k in limits)


def run(args, device="cuda", root=harness.ROOT):
    """One run of the cell; device "cpu" (the CPU tests' dry runs) skips
    the look for a card and reads no device memory."""
    import program
    cell = harness.load_cell(args.workload, root)
    import torch
    if device == "cuda":
        harness.require_chip(cell.entry["chips"])
    spans = harness.Spans()
    t_loop = time.perf_counter()
    loop = harness.driver_of(cell).Loop(cell, args.seed, spans, device)
    program.sync(device)
    setup_s = time.perf_counter() - T0
    pool = graph_pool_bytes(torch) if device == "cuda" else 0
    tr = cell.workload["trace"]
    stretch = harness.Stretch(spans, tr["skip"], tr["units"],
                              bool(args.trace))
    attempted = loop.run(args.seconds, stretch)
    program.sync(device)
    info = device_info(torch, cell.entry["chips"], device)
    result = {}
    if args.trace:
        if stretch.trace is None:
            raise BenchmarkError("the window ended before its profiled "
                                 "stretch")
        ctx = per_layer_context(cell, loop, stretch, spans, pool)
        metrics = {}
        for m in cell.per_layer:
            value = harness.metric_reader(cell, m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        busy = sum(b - a for a, b in harness.busy_intervals(
            stretch.trace.ops))
        a, b = stretch.trace.stretch
        info.update(busy_s=busy, window_s=b - a)
        result["breakdown"] = harness.breakdown(stretch.trace)
    else:
        values = dict(loop.end_to_end(), setup_s=setup_s,
                      peak_mem_gib=info["memory_peak_bytes"] / GIB)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    found = harness.forbidden_modules()
    if found:
        raise BenchmarkError(f"loaded after the window: {found}")

    # the check, after the window, the peak and the program's state
    t_check = time.perf_counter()
    loop.release()
    if device == "cuda":
        torch.cuda.empty_cache()
    from reference.compare import worst
    limits = cell.workload["limits"]
    readings = [loop.compare(g, w)
                for g, w in loop.answers(loop.reference())]
    wrong = sum(not within(r, limits) for r in readings)
    top = worst(readings)
    checks = {k: {"value": top.get(k), "limit": limits.get(k)}
              for k in sorted(set(top) | set(limits))}
    found = harness.forbidden_modules()
    if found:
        raise BenchmarkError(f"loaded after the check: {found}")
    out = {"correct": bool(readings) and within(top, limits),
           "attempted": attempted, "failed": wrong, "metrics": metrics,
           "device": info,
           **result, "checks": checks}
    print("set-up: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in dict(
            imports=t_loop - T0, **loop.setup_phases).items()),
        file=sys.stderr)
    print(f"phases: set-up {setup_s:.3f} s, window to check "
          f"{t_check - T0 - setup_s:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        out = run(args)
    except BenchmarkError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
