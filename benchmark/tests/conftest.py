"""The benchmark's own tests (python -m pytest benchmark/tests): on the
CPU at 64 columns, and the card tests (marker gpu), which skip where
torch sees no CUDA card. They import no jax."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(0, ROOT)

CELLS = ("rrtmg.refresh_c180", "rrtmgp.refresh_c90", "rrtmg.heartbeat_c90")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the card tests run on the chip")
    return "cuda"


def small_copy(dest, columns=64, block=32):
    """A checkout of BENCHMARK.json and benchmark/ under dest whose cells
    run `columns` columns, the reference in blocks of `block`; the port
    and the table data linked in."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(BENCH, os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for pkg in ("geosradiation_gridcomp_tpu_torch",
                "geosradiation_gridcomp_tpu"):
        os.symlink(os.path.join(ROOT, pkg), os.path.join(dest, pkg))
    wdir = os.path.join(dest, "benchmark", "workloads")
    for f in os.listdir(wdir):
        path = os.path.join(wdir, f)
        with open(path) as fh:
            w = json.load(fh)
        w["traffic"]["columns"] = columns
        w["reference_block"] = block
        with open(path, "w") as fh:
            json.dump(w, fh)
    return str(dest)


@pytest.fixture
def small(tmp_path):
    import torch
    torch.set_num_threads(1)
    return small_copy(tmp_path)
