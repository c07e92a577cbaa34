"""The RATS cell's yardstick (benchmark/reference/rt/driver/rats.py,
benchmark/reference/rats.py, benchmark/metrics/rats_*.py,
benchmark/rats_trace.py) on the CPU: the frozen reference bitwise equal
to the port's plain RATS at 64 x 72, the comparison's two numbers, and
the four readers on a synthetic trace, ring and counters, each None
where the port keeps no such record. Also their BENCHMARK.json entries
and the configuration file."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

from geosradiation_gridcomp_tpu_torch.driver import compiled, diagnostics
from geosradiation_gridcomp_tpu_torch.driver.compiled import CallRecord
from geosradiation_gridcomp_tpu_torch.driver.state import RatsState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
CELL = "rrtmg.rats_heartbeat_c90"
LAYER = "RATS diagnostics (driver/diagnostics.py rats_refresh, rats_update)"
PHASES = ("bind", "copy_in", "replay", "clone_out")
N, NLEV = 64, 72


@pytest.fixture
def bench(monkeypatch):
    monkeypatch.syspath_prepend(BENCH)
    import harness
    return harness


def _record(entry, call, key, start, ms):
    """A captured call whose four phases take ms[0] .. ms[3]."""
    stamps = [start]
    for m in ms:
        stamps.append(stamps[-1] + 1e-3 * m)
    return CallRecord(entry, call, key, PHASES, tuple(stamps))


def _lw(call, start, total_ms):
    return _record("rrtmg_lw", call, 9, start, (total_ms / 4,) * 4)


# three rrtmg_lw calls inside each of the first three `rats` spans (9, 3
# and 15 ms of phases summed: the lower median 9); two in the fourth,
# whose first call the ring dropped; one in the profiled span and one
# after it; a refresh's call in its own span
RECORDS = [
    _record("radiation_refresh", 0, 5, 9.01, (1, 1, 1, 1)),
    _lw(1, 10.01, 2), _lw(2, 10.02, 3), _lw(3, 10.03, 4),
    _lw(4, 11.01, 1), _lw(5, 11.02, 1), _lw(6, 11.03, 1),
    _lw(7, 11.51, 5), _lw(8, 11.52, 5), _lw(9, 11.53, 5),
    _lw(10, 11.81, 1), _lw(11, 11.82, 1),
    _lw(12, 12.01, 50),
    _lw(13, 13.01, 20),
]
SPANS = [("refresh", 9.0, 9.1, False),
         ("rats", 10.0, 10.1, False), ("sync", 10.1, 10.2, False),
         ("rats", 11.0, 11.1, False), ("rats", 11.5, 11.6, False),
         ("rats", 11.8, 11.9, False), ("rats", 12.0, 12.3, True),
         ("rats", 13.0, 13.1, False)]
ENTRY_COUNTS = {"rrtmg_lw": dict(capture_s=0.25, keys={
    9: dict(copies=30, fills=1, clones=14)})}
RATS_COUNTS = {"rats_refresh": dict(calls=4, solves=32, fills=32,
                                    copies=160),
               "rats_update": dict(calls=16, fills=0, copies=0)}

# rats_device_ms: 46 and 44 ms of kernels in the two windows; rats_idle_ms:
# 4 and 6 ms of their 50 ms idle; rats_host_ms: the lower median of 9, 3,
# 15; rats_copies: 8 solves a refresh of 45 copies, and (32 + 160) / 4 of
# RATS' own
EXPECTED = {"rats_device_ms": 45.0, "rats_idle_ms": 5.0,
            "rats_host_ms": 9.0, "rats_copies": 8 * 45.0 + 48.0}


def _trace():
    ranges = [("rats", 100.0, 100.010),
              ("rats_refresh/H2O", 100.0005, 100.004),
              ("rrtmg_lw/copy_in", 100.001, 100.0015),
              ("sync", 100.010, 100.050),
              ("rats", 100.1, 100.11), ("sync", 100.11, 100.15),
              ("update", 100.2, 100.201), ("sync", 100.201, 100.203)]
    ops = [("k", 100.002, 100.048, "kernel"),
           ("k", 100.105, 100.149, "kernel"),
           ("k", 100.2009, 100.2025, "kernel")]
    return SimpleNamespace(ops=ops, ranges=ranges, stretch=(99.9, 100.3))


def _ctx():
    return SimpleNamespace(trace=_trace(),
                           spans=SimpleNamespace(spans=list(SPANS)))


def _read(harness, name, ctx):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    return harness.load_module(path, f"bench_metric_{name}").read(ctx)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_synthetic_reading(bench, monkeypatch, name):
    monkeypatch.setattr(compiled, "recent_calls", lambda: tuple(RECORDS))
    monkeypatch.setattr(compiled, "counts", lambda: ENTRY_COUNTS)
    monkeypatch.setattr(diagnostics, "counts", lambda: RATS_COUNTS)
    assert _read(bench, name, _ctx()) == pytest.approx(EXPECTED[name],
                                                       rel=1e-6)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_none_without_the_ports_record(bench, monkeypatch,
                                                    name):
    """The port's counters gone, as at the parent commit, or its ring
    too, and a trace without `rats` spans: nothing to read. The device
    readers need no counter and read the trace while it has the spans."""
    monkeypatch.setattr(compiled, "recent_calls", lambda: tuple(RECORDS))
    monkeypatch.setattr(compiled, "counts", lambda: ENTRY_COUNTS)
    monkeypatch.delattr(diagnostics, "counts")
    ctx = _ctx()
    if name == "rats_copies":
        assert _read(bench, name, ctx) is None
    monkeypatch.delattr(compiled, "recent_calls")
    monkeypatch.delattr(compiled, "counts")
    if name == "rats_host_ms":
        assert _read(bench, name, ctx) is None
    ctx.trace.ranges = [r for r in ctx.trace.ranges if r[0] != "rats"]
    assert _read(bench, name, ctx) is None


def test_host_ms_counts_only_full_spans_before_the_stretch(bench,
                                                           monkeypatch):
    """The fourth span lost its first call to the ring, the fifth is
    profiled and the sixth comes after the stretch."""
    import rats_trace
    monkeypatch.setattr(compiled, "recent_calls", lambda: tuple(RECORDS))
    groups = rats_trace.lw_calls_by_span(_ctx())
    assert [[r.call for r in g] for g in groups] == [[1, 2, 3], [4, 5, 6],
                                                     [7, 8, 9]]


def test_entries_in_benchmark_json(bench):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    cell = bench.load_cell(CELL)
    assert [m["name"] for m in cell.per_layer] == list(EXPECTED)
    assert [m["name"] for m in cell.end_to_end] == [
        "cycle_ms", "peak_mem_gib", "setup_s"]
    for name in EXPECTED:
        m = per_layer[name]
        assert m["layer"] == LAYER and m["moves"] == "cycle_ms"
        assert m["workloads"] == [CELL]
    # appended, in order, after every metric the benchmark had before
    # them (K8_roofline the last); later entries may follow
    names = list(per_layer)
    first = names.index(next(iter(EXPECTED)))
    assert names[first:first + len(EXPECTED)] == list(EXPECTED)
    assert first == names.index("K8_roofline") + 1
    # appended after the cells the benchmark had before it; later cells
    # may follow
    cells = [w["name"] for w in spec["workloads"]]
    assert cells.index(CELL) == cells.index("rrtmg.heartbeat_c90") + 1
    assert spec["workloads"][cells.index(CELL)]["chips"] == 1
    assert set(cell.workload["limits"]) == {
        "sw_relmax", "lw_relmax", "cldfrc_maxdiff", "update_relmax",
        "rats_relmax", "forcing_relmax"}


def test_configuration_is_rrtmg_l72_with_every_rats_gas(bench):
    from geosradiation_gridcomp_tpu_torch.driver.diagnostics import \
        RATS_GASES
    base = bench.read_json(os.path.join(BENCH, "configs", "rrtmg_l72.json"))
    rats = bench.read_json(os.path.join(BENCH, "configs",
                                        "rrtmg_rats_l72.json"))
    assert rats["reduced"] == []
    assert tuple(rats["rats_gases"]) == RATS_GASES
    for k, v in base.items():
        if k not in ("name", "source", "assumed"):
            assert rats[k] == v, k


@pytest.fixture(scope="module")
def rats_case():
    """The port's plain RATS and the frozen reference's on one scene."""
    import sys
    sys.path.insert(0, BENCH)
    try:
        import harness
        import program
        import scene
        from reference.compare import Reference
        from reference.rats import RatsReference
    finally:
        sys.path.remove(BENCH)
    from geosradiation_gridcomp_tpu_torch.driver.diagnostics import (
        rats_refresh, rats_update)
    from geosradiation_gridcomp_tpu_torch.driver.radiation import \
        irrad_refresh
    from geosradiation_gridcomp_tpu_torch.kernels.twins import twins
    torch.set_num_threads(1)
    cfg = harness.read_json(os.path.join(BENCH, "configs",
                                         "rrtmg_rats_l72.json"))
    arrays = scene.scene(N, NLEV, 12)
    pcfg = program.port_config(cfg)
    inp = program.port_inputs(arrays, "cpu")
    ict, icb = program.superlayers(pcfg, arrays)
    with twins():
        port = rats_refresh(inp, 172.25, pcfg, ict, icb)
        irr = irrad_refresh(inp, 172.25, pcfg, ict, icb)
    ts = inp.tsinst + 0.6
    ref = RatsReference(Reference(cfg, arrays, "cpu", 40))
    want = ref.refresh(172.25)
    return dict(port=port, want=want, ref=ref, irr=irr, ts=ts,
                port_update=rats_update(port, irr, ts))


def test_reference_rats_equals_the_ports_plain_path(rats_case):
    """Bitwise, in blocks of 40 columns against the port's 64 at once."""
    for f in RatsState._fields:
        torch.testing.assert_close(getattr(rats_case["want"], f),
                                   getattr(rats_case["port"], f), rtol=0,
                                   atol=0, msg=f)


def test_reference_rats_update_equals_the_ports(rats_case):
    flx_rat, forcing, flx_all = rats_case["ref"].update(
        rats_case["want"], rats_case["irr"], rats_case["ts"])
    torch.testing.assert_close(flx_rat, rats_case["port_update"][0],
                               rtol=0, atol=0)
    torch.testing.assert_close(forcing, rats_case["port_update"][1],
                               rtol=0, atol=0)
    torch.testing.assert_close(flx_all, (forcing + flx_rat)[0], rtol=1e-5,
                               atol=1e-3)


def test_the_comparison_reads_each_gas_and_the_forcing(rats_case):
    """A gas's state off by 1e-3 of its flux reads about 1e-3 in
    rats_relmax; the forcing of every gas off by 1e-3 W/m^2 reads that
    over the largest |F_net(all)| in forcing_relmax; a missing gas reads
    inf."""
    import sys
    sys.path.insert(0, BENCH)
    try:
        from reference.rats import compare_rats, compare_rats_update
    finally:
        sys.path.remove(BENCH)
    want = rats_case["want"]
    assert compare_rats(want, want) == {"rats_relmax": 0.0}
    bad = RatsState(*(f.clone() for f in want))
    bad.flxu[7] *= 1.001
    assert compare_rats(bad, want)["rats_relmax"] == pytest.approx(
        1e-3, rel=1e-2)
    short = RatsState(*(f[:7] for f in want))
    assert compare_rats(short, want)["rats_relmax"] == float("inf")
    up = rats_case["ref"].update(want, rats_case["irr"], rats_case["ts"])
    got = (up[0], up[1] + 1e-3)
    scale = float(up[2].abs().max())
    assert compare_rats_update(got, up)["forcing_relmax"] == pytest.approx(
        1e-3 / scale, rel=1e-2)
