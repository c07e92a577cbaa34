"""The CPU tests' runs of the RATS cell (rrtmg.rats_heartbeat_c90), or
of another cell named: a small checkout of the benchmark (BENCHMARK.json
and benchmark/ copied, the packages linked in, the cell cut to a few
columns), a run of the cell in a fresh process, which loads no jax (the
tests' own process has), and the faults a run may break the port's RATS
with."""

import json
import os
import shutil
import subprocess
import sys

import torch

from geosradiation_gridcomp_tpu_torch.driver import diagnostics
from geosradiation_gridcomp_tpu_torch.driver.diagnostics import RATS_GASES
from geosradiation_gridcomp_tpu_torch.driver.radiation import irrad_refresh
from geosradiation_gridcomp_tpu_torch.driver.state import RatsState

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = os.path.join(ROOT, "benchmark")
CELL = "rrtmg.rats_heartbeat_c90"


def small_root(dest, columns=64, block=32, cell=CELL):
    """The checkout under dest; the cell runs `columns` columns and its
    reference blocks of `block`."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(BENCH, os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for pkg in ("geosradiation_gridcomp_tpu_torch",
                "geosradiation_gridcomp_tpu"):
        os.symlink(os.path.join(ROOT, pkg), os.path.join(dest, pkg))
    path = os.path.join(dest, "benchmark", "workloads", f"{cell}.json")
    with open(path) as f:
        w = json.load(f)
    w["traffic"]["columns"] = columns
    w["reference_block"] = block
    with open(path, "w") as f:
        json.dump(w, f)
    return str(dest)


def _unzeroed(fn):
    """HCFC22's entry solved with every gas present."""
    def wrapper(inp, doy, config, ict, icb, gases=RATS_GASES, **kw):
        out = fn(inp, doy, config, ict, icb, gases=gases, **kw)
        g = gases.index("HCFC22")
        full = irrad_refresh(inp, doy, config, ict, icb)
        return RatsState(*(torch.cat([f[:g], getattr(full, n)[None],
                                      f[g + 1:]])
                           for n, f in zip(RatsState._fields, out)))
    return wrapper


def _swapped(fn):
    """CFC11's and CFC12's solves in each other's place."""
    def wrapper(*args, gases=RATS_GASES, **kw):
        g = list(gases)
        i, j = g.index("CFC11"), g.index("CFC12")
        g[i], g[j] = g[j], g[i]
        return fn(*args, gases=tuple(g), **kw)
    return wrapper


def _not_advanced(fn):
    """The RATS fluxes left at the refresh's skin temperature."""
    return lambda rats, irr, ts: fn(rats, irr, irr.ts)


# name -> (the port's function it breaks, the fault)
FAULTS = {"unzeroed": ("rats_refresh", _unzeroed),
          "swapped": ("rats_refresh", _swapped),
          "not_advanced": ("rats_update", _not_advanced)}


def break_port(fault):
    """Replace the port's RATS function by its broken form; the loop
    looks it up when it starts."""
    name, make = FAULTS[fault]
    setattr(diagnostics, name, make(getattr(diagnostics, name)))


RUN = """
import json, sys, torch
torch.set_num_threads(1)
sys.path.insert(0, {bench!r})
sys.path.insert(0, {here!r})
if {fault!r}:
    import bench_rats_cell
    bench_rats_cell.break_port({fault!r})
import run
from types import SimpleNamespace
out = run.run(SimpleNamespace(workload={cell!r}, seed={seed},
                              seconds=0.5, trace=0), device="cpu",
              root={root!r})
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(dict(out=out, modules=top)))
"""


def run_cell(root, seed, fault=None, cell=CELL):
    """(run.run's result of one run of the cell under root in a fresh
    process on the CPU, the top-level modules it loaded, its stderr)."""
    code = RUN.format(bench=os.path.join(root, "benchmark"), here=HERE,
                      fault=fault, cell=cell, seed=seed, root=root)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=root,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    if p.returncode != 0:
        raise RuntimeError(p.stderr[-4000:])
    got = json.loads(p.stdout.strip().splitlines()[-1])
    return got["out"], got["modules"], p.stderr
