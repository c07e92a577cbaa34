"""K10's roofline count and the reader of K10_roofline: the count follows
the shapes alone and counts both streams in every column, lit or not; one
small shape gives the bytes and instructions worked out by hand; the
reader takes the kernel's device time from the trace, or reads nothing
where the kernel did not run."""

from types import SimpleNamespace

import numpy as np
import pytest

import harness
import program
import scene
from roofline import K10, peaks
from roofline.peaks import least_seconds

CONFIG = dict(ngpt_lw=140, ngpt_sw=112, nband_lw=16, nband_sw=14,
              solar_dt=3600.0)
SMALL = dict(ncol=2, nlay=3, ngpt_lw=140, ngpt_sw=112, nband_lw=16,
             nband_sw=14, cloudy_cols=2, cloudy_depth_lw=5, lit_cols=1,
             lit_cloudy_cols=1, cloudy_depth_sw=3)


def test_the_count_follows_the_shapes_alone():
    arrays = scene.scene(32, 72, 3)
    s = program.refresh_shapes(arrays, CONFIG, 172.5, 12.0)
    other = dict(s, cloudy_cols=0, lit_cols=0, lit_cloudy_cols=0,
                 cloudy_depth_sw=0, fcld=arrays["fcld"] * 0.5,
                 taug=np.ones((32, 72, 112)))
    assert K10.count(s) == K10.count(other)
    assert least_seconds(K10.count(s)) > 0.0


def test_small_shape_by_hand():
    c = K10.count(SMALL)
    # 2 columns x 3 layers x 112 g-points x 2 streams, night column too
    solves = 2 * 3 * 112 * 2
    # in: five fields of 6 cells x 112, toa_src 2 x 112, mu0 2, two
    # albedos 2 x 14; out: six profiles of 2 columns x 4 levels
    read = 4 * (5 * 6 * 112 + 2 * 112 + 2 + 2 * 2 * 14)
    written = 4 * 6 * 2 * 4
    assert (solves, read, written) == (1344, 14568, 192)
    assert c == dict(bytes=14760, sfu=7 * 1344, fp32=30 * 1344)
    assert least_seconds(c) == pytest.approx(max(
        14760 / peaks.HBM_BYTES_PER_S, 7 * 1344 / peaks.SFU_PER_S,
        37 * 1344 / peaks.ISSUE_PER_S))


def _ctx(ops):
    return SimpleNamespace(
        trace=SimpleNamespace(ops=ops), refresh_windows=[(0.0, 1.0)],
        shapes=[SMALL], bound=lambda stage: least_seconds(K10.count(SMALL)))


def test_the_reader_finds_the_kernel_in_the_trace():
    reader = harness.load_module(
        f"{harness.HERE}/metrics/K10_roofline.py", "bench_metric_K10")
    assert "rte_sw_kernel" in harness.port_kernel_names()
    t = least_seconds(K10.count(SMALL))
    name = "(anonymous namespace)::rte_sw_kernel((anonymous namespace)::Args)"
    # the one launch, taking four times the least time: 25 %
    ops = [(name, 0.1, 0.1 + 4 * t, "kernel"),
           ("void at::native::vectorized_elementwise_kernel", 0.2, 0.3,
            "kernel")]
    assert reader.read(_ctx(ops)) == pytest.approx(25.0)
    assert reader.read(_ctx(ops[1:])) is None
