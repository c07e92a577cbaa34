"""BENCHMARK.json and the files it names: every cell, configuration and
metric is found by name, the file keeps to its format's limits, and a
cell, configuration and metric added as files only are picked up."""

import json
import os
import re

import pytest

import harness
from conftest import CELLS, ROOT, small_copy

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_spec_keys_names_and_bounds():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["benchmark"]
    assert 1 <= s["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in s[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("benchmark/")
    pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m["workloads"]:
            reported = [x["name"] for x in harness.load_cell(w).end_to_end]
            assert m["moves"] in reported


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_and_metric_is_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert hasattr(harness.driver_of(c), "Loop")
    for m in c.per_layer:
        assert callable(harness.metric_reader(c, m["name"]).read)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert c.per_layer
    assert set(c.workload["limits"]) == {"sw_relmax", "lw_relmax",
                                         "cldfrc_maxdiff"} | (
        {"update_relmax"} if "heartbeat" in cell else set())


def test_a_cell_added_as_files_only_is_picked_up(tmp_path):
    """A new configuration, cell and per-layer metric: new files and new
    entries in BENCHMARK.json, no file of the benchmark edited."""
    root = small_copy(tmp_path)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "rrtmg_l72.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "rrtmg_l72_inhm2"
    cfg["condensate_inhomogeneity"] = 2
    with open(os.path.join(bench, "configs", "rrtmg_l72_inhm2.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "workloads",
                           "rrtmg.refresh_c180.json")) as f:
        w = json.load(f)
    w.update(name="rrtmg.inhm2_small", config="rrtmg_l72_inhm2")
    with open(os.path.join(bench, "workloads", "rrtmg.inhm2_small.json"),
              "w") as f:
        json.dump(w, f)
    with open(os.path.join(bench, "metrics", "units_profiled.py"),
              "w") as f:
        f.write("def read(ctx):\n    return ctx.units\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        s = json.load(f)
    s["configs"].append({"name": "rrtmg_l72_inhm2", "source": "x",
                         "file": "benchmark/configs/rrtmg_l72_inhm2.json",
                         "reduced": ["condensate_inhomogeneity"]})
    s["workloads"].append({"name": "rrtmg.inhm2_small",
                           "config": "rrtmg_l72_inhm2",
                           "traffic": "inhm2_small", "chips": 1,
                           "why": "a test"})
    s["end_to_end"][0]["workloads"].append("rrtmg.inhm2_small")
    s["per_layer"].append({"name": "units_profiled", "unit": "units",
                           "better": "higher", "source": "device_trace",
                           "layer": "device (H100)",
                           "moves": "refresh_cols_per_s",
                           "workloads": ["rrtmg.inhm2_small"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(s, f)
    c = harness.load_cell("rrtmg.inhm2_small", root)
    assert c.config["condensate_inhomogeneity"] == 2
    assert "units_profiled" in [m["name"] for m in c.per_layer]
    assert "refresh_cols_per_s" in [m["name"] for m in c.end_to_end]
    assert harness.metric_reader(c, "units_profiled").read(
        type("Ctx", (), {"units": 3})) == 3
    with pytest.raises(harness.BenchmarkError):
        harness.load_cell("rrtmg.no_such_cell", root)
