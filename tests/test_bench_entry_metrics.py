"""The benchmark's per-layer metrics of the captured entry
(benchmark/metrics/entry_*.py, capture_s.py, benchmark/entry_trace.py)
on a synthetic reading: the benchmark's spans, the port's call records
and counters, and a small trace with known gaps; each gives None on a
port that keeps no such record. Also their BENCHMARK.json entries."""

import json
import os
from types import SimpleNamespace

import pytest

from geosradiation_gridcomp_tpu_torch.driver import compiled
from geosradiation_gridcomp_tpu_torch.driver.compiled import CallRecord

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
LAYER = "captured entry (driver/compiled.py)"
REPLAYED = ("bind", "copy_in", "replay", "clone_out")

# ms of each phase, the lower median over the calls inside unprofiled
# spans before the stretch: the three refreshes give bind 2, copy_in 5,
# replay 7, clone_out 6; of the two updates, one paying 50 ms in its
# clone_out, the lower: 1, 2, 3, 1
EXPECTED = {
    "entry_bind_ms.refresh": 2.0, "entry_copy_in_ms.refresh": 5.0,
    "entry_replay_ms.refresh": 7.0, "entry_clone_out_ms.refresh": 6.0,
    "entry_bind_ms.update": 1.0, "entry_copy_in_ms.update": 2.0,
    "entry_replay_ms.update": 3.0, "entry_clone_out_ms.update": 1.0,
    "entry_copies.refresh": 72.0, "entry_copies.update": 32.0,
    "entry_idle_ms.refresh": 2.0, "entry_idle_ms.update": 0.9,
    "capture_s": 0.75,
}


def _record(entry, call, key, start, ms, phases=REPLAYED):
    stamps = [start]
    for m in ms:
        stamps.append(stamps[-1] + 1e-3 * m)
    return CallRecord(entry, call, key, phases, tuple(stamps))


RECORDS = [
    # set-up's capture, outside every span
    _record("radiation_refresh", 0, 5, 5.0, (1, 400, 1, 1, 1),
            ("bind", "capture") + REPLAYED[1:]),
    _record("radiation_update", 1, 7, 6.001, (1, 2, 3, 1)),
    # ends after its span
    _record("radiation_update", 2, 7, 7.001, (9, 9, 9, 9)),
    _record("radiation_update", 10, 7, 8.001, (2, 3, 4, 50)),
    _record("radiation_refresh", 3, 5, 10.01, (1, 4, 5, 10)),
    _record("radiation_refresh", 4, 5, 11.01, (3, 6, 10, 2)),
    _record("radiation_refresh", 11, 5, 11.51, (2, 5, 7, 6)),
    # another entry inside a refresh span
    _record("rrtmg_lw", 5, 9, 10.05, (9, 9, 9, 9)),
    # inside the profiled stretch's span
    _record("radiation_refresh", 6, 5, 12.01, (50, 50, 50, 50)),
    # inside unprofiled spans after the stretch, which the profiler's
    # residue slows
    _record("radiation_refresh", 7, 5, 13.01, (20, 20, 20, 20)),
    _record("radiation_update", 8, 7, 20.001, (2, 2, 2, 2)),
]
SPANS = [("update", 6.0, 6.01, False), ("update", 7.0, 7.02, False),
         ("update", 8.0, 8.1, False),
         ("refresh", 10.0, 10.1, False), ("sync", 10.1, 10.2, False),
         ("refresh", 11.0, 11.1, False), ("refresh", 11.5, 11.6, False),
         ("refresh", 12.0, 12.3, True),
         ("refresh", 13.0, 13.1, False), ("update", 20.0, 20.01, False)]
COUNTS = {
    "radiation_refresh": dict(capture_s=0.5, keys={
        5: dict(copies=30, fills=2, clones=40)}),
    "radiation_update": dict(capture_s=0.25, keys={
        7: dict(copies=20, fills=2, clones=10)}),
    "rrtmg_lw": dict(capture_s=0.0, keys={}),
}


def _trace():
    """Two refresh windows and an update window. The first refresh idles
    2.5 ms under radiation_refresh/bind and 1.5 ms under its copy_in,
    then 2 ms under sync; the second idles 5 ms under the bare refresh;
    the update idles 0.9 ms under radiation_update/copy_in."""
    ranges = [("refresh", 100.0, 100.010),
              ("radiation_refresh/bind", 100.001, 100.002),
              ("radiation_refresh/copy_in", 100.002, 100.004),
              ("radiation_refresh/replay", 100.004, 100.005),
              ("radiation_refresh/clone_out", 100.005, 100.006),
              ("sync", 100.010, 100.050),
              ("refresh", 100.1, 100.11), ("sync", 100.11, 100.15),
              ("update", 100.2, 100.201),
              ("radiation_update/copy_in", 100.2002, 100.2008),
              ("sync", 100.201, 100.203)]
    ops = [("copy", 100.0025, 100.003, "gpu_memcpy"),
           ("k", 100.0045, 100.048, "kernel"),
           ("k", 100.105, 100.149, "kernel"),
           ("k", 100.2009, 100.2025, "kernel")]
    return SimpleNamespace(ops=ops, ranges=ranges, stretch=(99.9, 100.3))


@pytest.fixture
def bench(monkeypatch):
    monkeypatch.syspath_prepend(BENCH)
    import harness
    return harness


def _ctx(harness):
    trace = _trace()
    return SimpleNamespace(
        trace=trace, spans=SimpleNamespace(spans=SPANS),
        refresh_windows=harness.unit_windows(trace, "refresh"),
        update_windows=harness.unit_windows(trace, "update"))


def _read(harness, name, ctx):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    return harness.load_module(path, f"bench_metric_{name}").read(ctx)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_synthetic_reading(bench, monkeypatch, name):
    monkeypatch.setattr(compiled, "recent_calls", lambda: tuple(RECORDS))
    monkeypatch.setattr(compiled, "counts", lambda: COUNTS)
    assert _read(bench, name, _ctx(bench)) == pytest.approx(
        EXPECTED[name], rel=1e-6)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_none_without_the_ports_record(bench, monkeypatch,
                                                    name):
    """A port that keeps no call record or counters, as the port did
    before it had them, and a trace without its ranges: nothing to
    read."""
    monkeypatch.delattr(compiled, "recent_calls")
    monkeypatch.delattr(compiled, "counts")
    ctx = _ctx(bench)
    ctx.trace.ranges = [r for r in ctx.trace.ranges if "/" not in r[0]]
    assert _read(bench, name, ctx) is None


def test_every_unprofiled_span_counts_in_a_run_never_profiled(bench,
                                                              monkeypatch):
    """With a profiled span, only the calls before it; without one, those
    after it too."""
    import entry_trace
    monkeypatch.setattr(compiled, "recent_calls", lambda: tuple(RECORDS))
    ctx = _ctx(bench)
    calls = [r.call for r in entry_trace.calls_in_spans(
        ctx, "radiation_refresh", "refresh")]
    assert calls == [3, 4, 11]
    ctx.spans.spans = [s for s in SPANS if not s[3]]
    calls = [r.call for r in entry_trace.calls_in_spans(
        ctx, "radiation_refresh", "refresh")]
    assert calls == [3, 4, 11, 7]
    assert [r.call for r in entry_trace.calls_in_spans(
        ctx, "radiation_update", "update")] == [1, 10, 8]
    # refreshes' bind 1, 3, 2, 20: the lower median 2
    assert _read(bench, "entry_bind_ms.refresh", ctx) == pytest.approx(
        2.0, rel=1e-6)


def test_entries_in_benchmark_json(bench):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in EXPECTED:
        m = per_layer[name]
        assert m["layer"] == LAYER
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{name}.py"))
        for cell in m["workloads"]:
            assert name in [x["name"]
                            for x in bench.load_cell(cell).per_layer]
            assert m["moves"] in [x["name"]
                                  for x in bench.load_cell(cell).end_to_end]
    # appended in one block, in order, after the entries before them;
    # later metrics are appended after the block
    names = list(per_layer)
    start = names.index(next(iter(EXPECTED)))
    assert names[start:start + len(EXPECTED)] == list(EXPECTED)
