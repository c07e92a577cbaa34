"""A dry run of each cell at 64 columns on the CPU, in a fresh process:
it loads no module whose top-level name is jax, jaxlib, flax or the JAX
package, and its result line has exactly the keys it must. The trace
reading is held to a synthetic trace."""

import json
import os
import subprocess
import sys

import pytest

import harness
from conftest import CELLS

DRY = """
import json, sys, torch
torch.set_num_threads(1)
sys.path.insert(0, {bench!r})
import run
from types import SimpleNamespace
out = run.run(SimpleNamespace(workload={cell!r}, seed=2**31 + 11,
                              seconds=0.5, trace=0), device="cpu",
              root={root!r})
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(dict(out=out, modules=top)))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_fresh_process_dry_run(cell, small):
    code = DRY.format(bench=os.path.join(small, "benchmark"), cell=cell,
                      root=small)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=small,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 0, p.stderr[-4000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert not set(got["modules"]) & {"jax", "jaxlib", "flax",
                                      "geosradiation_gridcomp_tpu"}
    assert "geosradiation_gridcomp_tpu_torch" in got["modules"]
    out = got["out"]
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {m["name"] for m in
                                   harness.load_cell(cell).end_to_end}
    assert p.stderr.strip().splitlines()[-1].startswith("check ")


def test_run_refuses_without_a_card(tmp_path):
    p = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"),
                        "--workload", CELLS[0], "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "geosradiation_gridcomp_tpu_torch_x",
                        sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert harness.forbidden_modules() == ["jaxlib"]


def test_trace_reading_busy_idle_and_breakdown():
    """Two refreshes of two kernels each, an idle gap inside a refresh
    span and one inside a sync span; times in microseconds."""
    ev = [dict(ph="X", cat="user_annotation", name="stretch", ts=0, dur=100),
          dict(ph="X", cat="user_annotation", name="refresh", ts=0, dur=10),
          dict(ph="X", cat="user_annotation", name="sync", ts=10, dur=40),
          dict(ph="X", cat="user_annotation", name="refresh", ts=50, dur=10),
          dict(ph="X", cat="user_annotation", name="sync", ts=60, dur=40),
          dict(ph="X", cat="kernel", name="void k<3>(float*)", ts=5, dur=20),
          dict(ph="X", cat="kernel", name="(anonymous namespace)::g(int)",
               ts=30, dur=10),
          dict(ph="X", cat="kernel", name="void k<3>(float*)", ts=55, dur=20),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoD", ts=80, dur=10)]
    tr = harness.read_trace({"traceEvents": ev})
    flat = [t for iv in harness.busy_intervals(tr.ops) for t in iv]
    assert flat == pytest.approx([5e-6, 25e-6, 30e-6, 40e-6, 55e-6, 75e-6,
                                  80e-6, 90e-6])
    ctx = type("Ctx", (), dict(trace=tr))
    assert harness.idle_pct(ctx) == pytest.approx(40.0)
    flat = [t for w in harness.unit_windows(tr, "refresh") for t in w]
    assert flat == pytest.approx([0.0, 50e-6, 50e-6, 100e-6])
    assert harness.kernel_base("void k<3>(float*)") == "k"
    assert harness.kernel_base("(anonymous namespace)::g(int)") == "g"
    b = harness.breakdown(tr)
    assert b["device_ops"][0] == ["void k<3>(float*)", pytest.approx(40e-6)]
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"refresh": 5e-6, "sync": 35e-6})
