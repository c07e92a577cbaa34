"""The benchmark's machinery: finding a cell's files by name, the spans
the benchmark records around its calls into the port, the profiled
stretch of a traced run and the readings taken from its trace.

Everything that belongs to one configuration, traffic mix, loop or
per-layer metric sits in a file of its own, found by name:

    BENCHMARK.json                    the cells and the metrics
    benchmark/configs/<config>.json   one configuration
    benchmark/workloads/<cell>.json   one cell: its traffic, its loop, its
                                      correctness limits
    benchmark/drivers/<driver>.py     one timed loop (class Loop)
    benchmark/metrics/<metric>.py     one per-layer metric (read(ctx))
    benchmark/roofline/<stage>.py     the work of one kernel stage

Nothing here imports jax, the JAX package or, at import, the port.
"""

import contextlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "geosradiation_gridcomp_tpu")


class BenchmarkError(RuntimeError):
    """A cell that cannot run: no such file, no card, a forbidden module."""


def benchmark_spec(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def read_json(path):
    if not os.path.exists(path):
        raise BenchmarkError(f"no such file: {path}")
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """The Python file path as a module of its own (file names may hold
    dots, so they are not imported as packages)."""
    if not os.path.exists(path):
        raise BenchmarkError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name, root=ROOT):
    """A cell by its name: its BENCHMARK.json entry, its workload file,
    its configuration file, and the end-to-end and per-layer metrics it
    reports."""
    spec = benchmark_spec(root)
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise BenchmarkError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[name]
    here = os.path.join(root, "benchmark")
    workload = read_json(os.path.join(here, "workloads", f"{name}.json"))
    configs = {c["name"]: c for c in spec["configs"]}
    config = read_json(os.path.join(root, configs[entry["config"]]["file"]))
    if workload["config"] != entry["config"] \
            or config["name"] != entry["config"]:
        raise BenchmarkError(f"{name}: configuration names disagree")
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layers = [m for m in spec["per_layer"]
              if (name in m["workloads"] if "workloads" in m
                  else m["moves"] in reported)]
    return SimpleNamespace(name=name, entry=entry, workload=workload,
                           config=config, end_to_end=e2e, per_layer=layers,
                           root=root)


def driver_of(cell):
    return load_module(os.path.join(cell.root, "benchmark", "drivers",
                                    f"{cell.workload['driver']}.py"),
                       f"bench_driver_{cell.workload['driver']}")


def metric_reader(cell, name):
    return load_module(os.path.join(cell.root, "benchmark", "metrics",
                                    f"{name}.py"), f"bench_metric_{name}")


def require_chip(count):
    """Raise unless torch sees at least count CUDA devices: the benchmark
    measures the card and never falls back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise BenchmarkError("torch.cuda.is_available() is false: the "
                             "benchmark runs only on a CUDA card")
    if torch.cuda.device_count() < count:
        raise BenchmarkError(f"the cell asks for {count} cards, torch sees "
                             f"{torch.cuda.device_count()}")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is jax, jaxlib,
    flax or the JAX package (the port's own name only begins with it)."""
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


class Spans:
    """The benchmark's own host spans around its calls into the port:
    (name, start, end, profiled) on the host clock, kept in memory. While
    a stretch is profiled each span is also a torch.profiler range, so the
    trace can name what the host was doing in an idle gap."""

    def __init__(self):
        self.spans = []
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name):
        if self.profiling:
            import torch
            rng = torch.profiler.record_function(name)
            rng.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if self.profiling:
                rng.__exit__(None, None, None)
            self.spans.append((name, t0, t1, self.profiling))

    def durations(self, name):
        """The host seconds of every span `name` outside the stretch."""
        return [t1 - t0 for n, t0, t1, p in self.spans
                if n == name and not p]


class Stretch:
    """The profiled stretch of a traced run: units skip .. skip + units of
    the window under torch.profiler (CPU and CUDA activity), its trace
    read into kernel intervals and span ranges when it stops. A loop
    calls at_unit(i) before unit i and once after its last unit."""

    def __init__(self, spans, skip, units, enabled):
        self.spans, self.skip, self.units = spans, skip, units
        self.enabled = enabled
        self.prof = self.trace = None
        self.first = None
        self.count = 0

    @property
    def pending(self):
        """Whether the loop must go on for the stretch to be profiled."""
        return self.enabled and self.trace is None

    def at_unit(self, i):
        if not self.enabled:
            return
        if i == self.skip and self.prof is None:
            import torch
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.spans.profiling = True
            self._range = torch.profiler.record_function("stretch")
            self._range.__enter__()
            self.first = i
        elif self.prof is not None and self.trace is None \
                and i >= self.skip + self.units:
            self._stop(i)

    def _stop(self, i):
        import torch
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.spans.profiling = False
        self.prof.__exit__(None, None, None)
        self.count = i - self.first
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = read_trace(json.load(f))
        finally:
            os.remove(path)
        self.prof = None


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_trace(chrome):
    """The profiled stretch from a chrome trace: the device operations as
    (name, start, end, category) in seconds, the benchmark's spans as
    (name, start, end), and the stretch's own range."""
    ops, ranges, stretch = [], [], None
    for e in chrome.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        t0 = float(e["ts"]) * 1e-6
        t1 = t0 + float(e["dur"]) * 1e-6
        if cat in DEVICE_CATS:
            ops.append((e["name"], t0, t1, cat))
        elif cat == "user_annotation":
            if e["name"] == "stretch":
                stretch = (t0, t1)
            else:
                ranges.append((e["name"], t0, t1))
    if stretch is None:
        raise BenchmarkError("the trace holds no stretch range")
    ops = [o for o in ops if o[2] > stretch[0] and o[1] < stretch[1]]
    return SimpleNamespace(ops=ops, ranges=ranges, stretch=stretch)


def busy_intervals(ops):
    """The union of the device operations' intervals, merged and sorted."""
    merged = []
    for _, t0, t1, _ in sorted(ops, key=lambda o: o[1]):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged


def device_time_within(ops, windows):
    """Device seconds of the ops that start in one of the (start, end)
    windows."""
    return sum(t1 - t0 for _, t0, t1, _ in ops
               if any(a <= t0 < b for a, b in windows))


def unit_windows(trace, name):
    """(start, end) of each call named name in the stretch, from its span's
    start to the end of the sync span that follows it: the loops
    synchronise after each call, so the device work of the call lies in
    that window."""
    rs = sorted(trace.ranges, key=lambda r: r[1])
    out = []
    for k, (n, t0, t1) in enumerate(rs):
        if n != name:
            continue
        end = next((r[2] for r in rs[k + 1:] if r[0] == "sync"), t1)
        out.append((t0, end))
    return out


def breakdown(trace):
    """The device operations that took most time, by name, and the idle
    gaps of the stretch by the innermost benchmark span open at their
    middle ("harness" where none was), each summed, at most 10 each."""
    by_op = {}
    for name, t0, t1, _ in trace.ops:
        by_op[name] = by_op.get(name, 0.0) + (t1 - t0)
    a, b = trace.stretch
    gaps, edge = {}, a
    for s, e in busy_intervals(trace.ops) + [[b, b]]:
        if s > edge:
            mid = 0.5 * (edge + s)
            open_ = [r for r in trace.ranges if r[1] <= mid < r[2]]
            name = min(open_, key=lambda r: r[2] - r[1])[0] if open_ \
                else "harness"
            gaps[name] = gaps.get(name, 0.0) + (s - edge)
        edge = max(edge, e)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}


def port_kernel_names(root=ROOT):
    """The names of the port's own CUDA kernels: every __global__
    function of its csrc/*.cu."""
    import re
    csrc = os.path.join(root, "geosradiation_gridcomp_tpu_torch", "csrc")
    names = set()
    for f in sorted(os.listdir(csrc)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, f)) as fh:
                src = fh.read()
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)\s*\(", src))
    return names


def kernel_base(name):
    """A device operation's kernel name without its namespace, template
    arguments and parameters: `void ns::k<7>(float*)` -> `k`."""
    name = name.replace("(anonymous namespace)::", "")
    head = name.split("(")[0].split("<")[0].strip()
    return head.split()[-1].split("::")[-1] if head else ""


def roofline_share(ctx, stage, kernel):
    """The share (%) of the stage's roofline that the kernel reaches over
    the profiled refreshes: the least time of their work at their shapes
    (roofline/<stage>.py) over the kernel's device time in them; None
    where the kernel did not run."""
    t = device_time_within([o for o in ctx.trace.ops if o[3] == "kernel"
                            and kernel_base(o[0]) == kernel],
                           ctx.refresh_windows)
    if t <= 0.0 or len(ctx.refresh_windows) != len(ctx.shapes):
        return None
    return 100.0 * ctx.bound(stage) / t


def idle_pct(ctx):
    """The share (%) of the profiled stretch with no device operation."""
    a, b = ctx.trace.stretch
    busy = sum(e - s for s, e in busy_intervals(ctx.trace.ops))
    return 100.0 * (1.0 - busy / (b - a))


def mean_span_ms(ctx, name):
    """The mean host time (ms) of the benchmark's span `name` over the
    window outside the profiled stretch."""
    d = ctx.spans.durations(name)
    return 1e3 * sum(d) / len(d) if d else None
