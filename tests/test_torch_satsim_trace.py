"""The port's COSP ranges and radar counter (satsim/cosp.py,
satsim/radar.py:counts) on the CPU at 6 points x 16 subcolumns x 72
levels on chip_smoke's satsim scene: "cosp/<stage>" are profiler ranges
only while a profiler records, and the outputs are bitwise those of an
unprofiled call; counts() gives, for the key of shapes the radar ran
at, the blocks that PLANE_BYTES implies and the bytes of its planes,
as a copy. That a replay stays bitwise equal to the eager body is
tests/test_torch_satsim_capture.py's."""

import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from geosradiation_gridcomp_tpu_torch.ops import threefry
from geosradiation_gridcomp_tpu_torch.parallel.sharding import tree_leaves
from geosradiation_gridcomp_tpu_torch.satsim import SatsimConfig, cosp
from geosradiation_gridcomp_tpu_torch.satsim import radar as qb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import satsim_inputs  # noqa: E402

NPNT, NCOL, NLEV = 6, 16, 72
CFG = SatsimConfig(ncolumns=NCOL)
STAGES = {"cosp/scops", "cosp/isccp", "cosp/misr", "cosp/modis",
          "cosp/lidar", "cosp/radar", "cosp/stats"}


@pytest.fixture(scope="module")
def inp():
    torch.set_num_threads(1)
    return satsim_inputs(torch, NPNT, "cpu")


def _call(inp):
    return cosp.cosp_simulator_eager(threefry.key(5, device="cpu"), inp,
                                     CFG)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_ranges_only_under_a_profiler(inp, monkeypatch):
    opened = []
    record = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return record(name, *args)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    plain = _call(inp)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _call(inp)
    assert set(opened) == STAGES
    # the stats range twice: the lidar's and the radar's statistics
    assert sorted(opened).count("cosp/stats") == 2
    assert len(opened) == len(STAGES) + 1
    assert STAGES <= {e.name for e in prof.events()}
    assert _equal(traced, plain)


def test_radar_counts_the_blocks_plane_bytes_implies(inp, monkeypatch):
    per_point = NCOL * NLEV * qb.ND * 4
    monkeypatch.setattr(qb, "PLANE_BYTES", 2 * per_point)
    monkeypatch.setattr(qb, "_COUNTS", {})
    _call(inp)
    key = (cosp.PRESENT, (NPNT, NCOL, NLEV), "torch.float32")
    assert qb.counts() == {key: dict(
        blocks=3, points_per_block=2, classes=len(cosp.PRESENT),
        points=NPNT, plane_bytes=len(cosp.PRESENT) * NPNT * per_point)}
    # 5 points in blocks of 2: the last block holds one
    monkeypatch.setattr(qb, "_COUNTS", {})
    cosp.cosp_simulator_eager(threefry.key(5, device="cpu"),
                              type(inp)(*(x[:5] for x in inp)), CFG)
    (got,) = qb.counts().values()
    assert got["blocks"] == 3 and got["points"] == 5
    # a copy: writing into it changes nothing of the counter
    got["blocks"] = 0
    assert qb.counts()[(cosp.PRESENT, (5, NCOL, NLEV),
                        "torch.float32")]["blocks"] == 3


def test_radar_counts_at_the_default_plane_bytes(inp, monkeypatch):
    """One block of every point at these shapes."""
    monkeypatch.setattr(qb, "_COUNTS", {})
    _call(inp)
    (got,) = qb.counts().values()
    assert got["blocks"] == 1 and got["points_per_block"] >= NPNT
    assert got["plane_bytes"] == got["classes"] * NPNT * NCOL * NLEV \
        * qb.ND * 4
