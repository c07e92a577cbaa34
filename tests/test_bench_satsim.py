"""The SATSIM cell's yardstick (benchmark/reference/rt/satsim/,
benchmark/reference/satsim.py, benchmark/satsim_scene.py,
benchmark/metrics/satsim_*.py, benchmark/satsim_trace.py) on the CPU at
16 points x 50 subcolumns x 72 levels: the frozen reference's COSP
bitwise equal to the port's body under two keys, the comparison's four
numbers 0 on equal answers and beyond the cell's limits for the
bfloat16 control, the previous alarm's key, rain left out of the radar
and a wrong fill position; the four readers on a synthetic trace, ring
and counter, each None where the port keeps no such record; a run of
the cell in a fresh process, which loads no jax; and the BENCHMARK.json
entries and the configuration file."""

import dataclasses
import json
import os
import sys
from types import SimpleNamespace

import pytest
import torch

from geosradiation_gridcomp_tpu_torch.driver import compiled
from geosradiation_gridcomp_tpu_torch.driver.compiled import CallRecord
from geosradiation_gridcomp_tpu_torch.satsim import (SatsimConfig,
                                                     SatsimInputs, cosp,
                                                     prec_scops, radar)

from bench_rats_cell import ROOT, run_cell, small_root

BENCH = os.path.join(ROOT, "benchmark")
CELL = "cosp.satsim_c90"
LAYER = "COSP satellite simulators (satsim/cosp.py cosp_simulator)"
EXPECTED = ("satsim_device_ms", "satsim_kernels", "satsim_host_ms",
            "satsim_plane_gib")
NUMBERS = ("satsim_relmax", "satsim_fill_mismatch", "satsim_int_mismatch",
           "satsim_count_flips")
N, NLEV, SEED, ALARMS = 16, 72, 2**31 + 5, (7, 13)


def _bench():
    """The benchmark's modules, imported with benchmark/ on the path."""
    sys.path.insert(0, BENCH)
    try:
        import harness
        import satsim_scene
        import scene
        from reference import satsim as ref_satsim
        from reference.compare import Reference
    finally:
        sys.path.remove(BENCH)
    return SimpleNamespace(harness=harness, satsim_scene=satsim_scene,
                           scene=scene, ref=ref_satsim, Reference=Reference)


@pytest.fixture(scope="module")
def case():
    """The port's body and the frozen reference's COSP at two alarms, each
    with its own key, and the reference's control at the first."""
    torch.set_num_threads(1)
    b = _bench()
    config = b.harness.read_json(os.path.join(BENCH, "configs",
                                              "cosp_l72.json"))
    arrays = b.scene.scene(N, NLEV, 3)
    alarms = [(172.0 + h / 24.0, float(h)) for h in range(24)]
    ref = b.Reference(config, arrays, "cpu", N)
    sat = b.ref.SatsimReference(ref, arrays, config, SEED, alarms)
    cfg = SatsimConfig(**config["satsim"])
    base = {k: torch.as_tensor(v)
            for k, v in b.satsim_scene.fields(arrays).items()}

    def port(k, key=None, present=None):
        inp = SatsimInputs(**base, mcosz=b.satsim_scene.mcosz(
            arrays, *alarms[k], config["solar_dt"], "cpu"))
        key = b.satsim_scene.key(SEED, k if key is None else key, 24, "cpu")
        saved = cosp.PRESENT
        cosp.PRESENT = present or saved
        try:
            out = cosp.cosp_simulator_eager(key, inp, cfg)
        finally:
            cosp.PRESENT = saved
        out["prec_frac"] = prec_scops(inp.qr + inp.qs + inp.qg,
                                      torch.zeros_like(inp.qr),
                                      out["frac_out"])
        return out
    ctrl = b.ref.SatsimReference(b.Reference(config, arrays, "cpu", N,
                                             control=True),
                                 arrays, config, SEED, alarms)
    workload = b.harness.read_json(os.path.join(BENCH, "workloads",
                                                f"{CELL}.json"))
    return dict(b=b, port=port, ports={k: port(k) for k in ALARMS},
                refs={k: sat.cosp(k) for k in ALARMS},
                control=ctrl.cosp(ALARMS[0]), limits=workload["limits"])


@pytest.mark.parametrize("k", ALARMS)
def test_reference_cosp_equals_the_ports_body(case, k):
    """Every output and prec_frac bitwise, integers and counts included."""
    leaves = case["b"].ref.leaves
    want = dict(leaves(case["refs"][k]))
    got = dict(leaves(case["ports"][k]))
    assert set(got) == set(want)
    assert "frac_out" in got and "modis/l2/phase" in got
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        assert torch.equal(got[name], w), name


def test_the_four_numbers_read_zero_on_equal_answers(case):
    k = ALARMS[0]
    assert case["b"].ref.compare_satsim(case["ports"][k], case["refs"][k]) \
        == dict.fromkeys(NUMBERS, 0.0)


def _beyond(reading, limits, names):
    return {n for n in names if reading[n] > limits[n]}


def test_the_control_fails_the_float_fill_and_count_limits(case):
    """The reference as a bfloat16 program: inputs and answers rounded."""
    k = ALARMS[0]
    r = case["b"].ref.compare_satsim(case["control"], case["refs"][k])
    assert _beyond(r, case["limits"], NUMBERS) >= {
        "satsim_relmax", "satsim_fill_mismatch", "satsim_count_flips"}, r


def test_the_previous_alarms_key_fails_the_integers(case):
    k = ALARMS[1]
    r = case["b"].ref.compare_satsim(case["port"](k, key=k - 1),
                                     case["refs"][k])
    assert r["satsim_int_mismatch"] > case["limits"]["satsim_int_mismatch"]
    assert r["satsim_relmax"] > case["limits"]["satsim_relmax"]


def test_rain_left_out_of_the_radar_fails(case):
    k = ALARMS[0]
    no_rain = tuple(c for c in cosp.PRESENT if c != cosp.I_LSRAIN)
    r = case["b"].ref.compare_satsim(case["port"](k, present=no_rain),
                                     case["refs"][k])
    assert r["satsim_int_mismatch"] == 0.0
    assert _beyond(r, case["limits"], NUMBERS) >= {"satsim_relmax"}, r


def test_a_wrong_fill_position_fails(case):
    k = ALARMS[0]
    want = case["refs"][k]
    got = dict(want, radar=dict(want["radar"]))
    dbze = want["radar"]["dbze"].clone()
    echo = (dbze > radar.MISSING_DBZ).nonzero()[0]
    dbze[tuple(echo)] = radar.MISSING_DBZ
    got["radar"]["dbze"] = dbze
    r = case["b"].ref.compare_satsim(got, want)
    assert r["satsim_fill_mismatch"] == 1.0
    assert r["satsim_fill_mismatch"] > case["limits"]["satsim_fill_mismatch"]
    assert r["satsim_relmax"] == 0.0


def test_a_missing_output_reads_inf(case):
    k = ALARMS[0]
    got = dict(case["ports"][k])
    del got["prec_frac"]
    r = case["b"].ref.compare_satsim(got, case["refs"][k])
    assert r == dict.fromkeys(NUMBERS, float("inf"))


# ---------------------------------------------------------------------------
# the readers

PHASES = ("bind", "copy_in", "replay", "clone_out")


def _cosp(call, start, total_ms):
    stamps = [start]
    for _ in PHASES:
        stamps.append(stamps[-1] + 1e-3 * total_ms / 4)
    return CallRecord("cosp_simulator", call, 4, PHASES, tuple(stamps))


# one cosp_simulator call in each of three `satsim` spans before the
# stretch (2, 6 and 3 ms: the lower median 3), one in the profiled span,
# one after it; a refresh's call in its own span
RECORDS = [
    CallRecord("radiation_refresh", 0, 5, PHASES,
               (9.01, 9.02, 9.03, 9.04, 9.05)),
    _cosp(1, 10.01, 2), _cosp(2, 11.01, 6), _cosp(3, 11.51, 3),
    _cosp(4, 12.01, 50), _cosp(5, 13.01, 20),
]
SPANS = [("refresh", 9.0, 9.1, False),
         ("satsim", 10.0, 10.1, False), ("sync", 10.1, 10.2, False),
         ("satsim", 11.0, 11.1, False), ("satsim", 11.5, 11.6, False),
         ("satsim", 12.0, 12.3, True), ("satsim", 13.0, 13.1, False)]
PLANE = 5 * 8100 * 50 * 72 * 85 * 4
RADAR = {((0, 1, 2, 3, 8), (8100, 50, 72), "torch.float32"): dict(
    blocks=10, points_per_block=877, classes=5, points=8100,
    plane_bytes=PLANE),
    ((0, 1, 2, 3, 8), (16, 50, 72), "torch.float32"): dict(
    blocks=1, points_per_block=877, classes=5, points=16,
    plane_bytes=5 * 16 * 50 * 72 * 85 * 4)}

# satsim_device_ms: 880 ms of kernels and a 10 ms copy in the first
# window, 860 ms of kernels in the second (the refresh's kernel before
# them and the update's after do not count); satsim_kernels: 3 and 2
READINGS = {"satsim_device_ms": 875.0, "satsim_kernels": 2.5,
            "satsim_host_ms": 3.0, "satsim_plane_gib": PLANE / 2.0 ** 30}


def _trace():
    ranges = [("refresh", 99.95, 99.96), ("sync", 99.96, 99.99),
              ("satsim", 100.0, 100.002), ("sync", 100.002, 100.9),
              ("satsim", 101.0, 101.002), ("sync", 101.002, 101.9),
              ("update", 101.95, 101.951), ("sync", 101.951, 101.96)]
    ops = [("r", 99.961, 99.98, "kernel"),
           ("a", 100.0, 100.3, "kernel"), ("b", 100.3, 100.6, "kernel"),
           ("c", 100.6, 100.88, "kernel"),
           ("m", 100.88, 100.89, "gpu_memcpy"),
           ("a", 101.0, 101.5, "kernel"), ("b", 101.5, 101.86, "kernel"),
           ("u", 101.952, 101.953, "kernel")]
    return SimpleNamespace(ops=ops, ranges=ranges, stretch=(99.9, 102.0))


def _ctx():
    return SimpleNamespace(trace=_trace(), shapes=[dict(ncol=8100)],
                           spans=SimpleNamespace(spans=list(SPANS)))


@pytest.fixture
def bench(monkeypatch):
    monkeypatch.syspath_prepend(BENCH)
    import harness
    return harness


def _read(harness, name, ctx):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    return harness.load_module(path, f"bench_metric_{name}").read(ctx)


@pytest.mark.parametrize("name", EXPECTED)
def test_reader_on_a_synthetic_reading(bench, monkeypatch, name):
    monkeypatch.setattr(compiled, "recent_calls", lambda: tuple(RECORDS))
    monkeypatch.setattr(radar, "counts", lambda: RADAR)
    assert _read(bench, name, _ctx()) == pytest.approx(READINGS[name],
                                                       rel=1e-6)


@pytest.mark.parametrize("name", EXPECTED)
def test_reader_gives_none_without_the_ports_record(bench, monkeypatch,
                                                    name):
    """The port's ring and radar counter gone (the radar counter is new,
    so the parent commit has none), and a trace without `satsim` spans:
    nothing to read."""
    monkeypatch.setattr(compiled, "recent_calls", lambda: tuple(RECORDS))
    monkeypatch.delattr(radar, "counts")
    ctx = _ctx()
    if name == "satsim_plane_gib":
        assert _read(bench, name, ctx) is None
    monkeypatch.delattr(compiled, "recent_calls")
    if name == "satsim_host_ms":
        assert _read(bench, name, ctx) is None
    ctx.trace.ranges = [r for r in ctx.trace.ranges if r[0] != "satsim"]
    ctx.spans.spans = [s for s in ctx.spans.spans if s[0] != "satsim"]
    assert _read(bench, name, ctx) is None


# ---------------------------------------------------------------------------
# a run in a fresh process, BENCHMARK.json and the configuration

def test_fresh_process_dry_run_is_correct(tmp_path):
    root = small_root(tmp_path, columns=16, block=16, cell=CELL)
    out, modules, stderr = run_cell(root, 2**31 + 17, cell=CELL)
    assert not set(modules) & {"jax", "jaxlib", "flax",
                               "geosradiation_gridcomp_tpu"}
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"cycle_ms", "peak_mem_gib", "setup_s"}
    assert set(NUMBERS) <= set(out["checks"])
    assert all(out["checks"][n]["value"] == 0.0 for n in NUMBERS)
    assert "satsim_warm_up" in stderr


def test_entries_in_benchmark_json(bench):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell = bench.load_cell(CELL)
    assert [m["name"] for m in cell.end_to_end] == [
        "cycle_ms", "peak_mem_gib", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "graph_pool_gib", "capture_s", *EXPECTED]
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in EXPECTED:
        m = per_layer[name]
        assert m["layer"] == LAYER and m["moves"] == "cycle_ms"
        assert m["workloads"] == [CELL]
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{name}.py"))
    names = list(per_layer)
    first = names.index(EXPECTED[0])
    assert names[first:first + len(EXPECTED)] == list(EXPECTED)
    assert first == names.index("K10_roofline") + 1
    cells = [w["name"] for w in spec["workloads"]]
    assert cells.index(CELL) == cells.index("rrtmg.rats_heartbeat_c90") + 1
    assert cell.entry["chips"] == 1
    assert cell.workload["driver"] == "satsim_heartbeat_loop"
    rats = bench.read_json(os.path.join(BENCH, "workloads",
                                        "rrtmg.rats_heartbeat_c90.json"))
    assert cell.workload["traffic"] == rats["traffic"]
    limits = cell.workload["limits"]
    for k in ("sw_relmax", "lw_relmax", "cldfrc_maxdiff", "update_relmax"):
        assert limits[k] == rats["limits"][k], k
    assert set(limits) == set(rats["limits"]) - {
        "rats_relmax", "forcing_relmax"} | set(NUMBERS)
    assert limits["satsim_fill_mismatch"] == 0.0
    assert limits["satsim_int_mismatch"] == 0.0


def test_configuration_is_rrtmg_l72_with_satsims_defaults(bench):
    base = bench.read_json(os.path.join(BENCH, "configs", "rrtmg_l72.json"))
    cfg = bench.read_json(os.path.join(BENCH, "configs", "cosp_l72.json"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entry = {c["name"]: c for c in json.load(f)["configs"]}["cosp_l72"]
    assert cfg["reduced"] == [] and entry["reduced"] == []
    assert cfg["source"] == entry["source"] and len(cfg["source"]) <= 200
    assert entry["file"] == "benchmark/configs/cosp_l72.json"
    for word in ("GEOSsatsim_GridComp", "SIM_DRIVER", "COSP v1.x",
                 "SATSIM_NCOLUMNS 50", "McICA", "L72"):
        assert word in cfg["source"], word
    assert len(cfg["assumed"]) >= 5
    for k, v in base.items():
        if k not in ("name", "source", "assumed"):
            assert cfg[k] == v, k
    assert cfg["satsim"] == dataclasses.asdict(SatsimConfig())
    assert cfg["satsim"]["ncolumns"] == 50 and cfg["satsim"]["nlr"] == 40
