"""K9's roofline count and the reader of K9_roofline: the count follows
the shapes alone, one small shape gives the bytes worked out by hand, and
the reader takes the kernel's device time from the trace (both of its
template instances), or reads nothing where the kernel did not run."""

from types import SimpleNamespace

import numpy as np
import pytest

import harness
import program
import scene
from roofline import K9, peaks
from roofline.peaks import least_seconds

CONFIG = dict(ngpt_lw=140, ngpt_sw=112, nband_lw=16, nband_sw=14,
              solar_dt=3600.0)
SMALL = dict(ncol=2, nlay=3, ngpt_lw=140, ngpt_sw=112, nband_lw=16,
             nband_sw=14, cloudy_cols=2, cloudy_depth_lw=5, lit_cols=1,
             lit_cloudy_cols=1, cloudy_depth_sw=3)


def test_the_count_follows_the_shapes_alone():
    arrays = scene.scene(32, 72, 3)
    s = program.refresh_shapes(arrays, CONFIG, 172.5, 12.0)
    other = dict(s, cloudy_cols=0, cloudy_depth_lw=0, lit_cols=0,
                 fcld=arrays["fcld"] * 0.5, taug=np.ones((32, 72, 140)))
    assert K9.count(s) == K9.count(other)
    assert least_seconds(K9.count(s)) > 0.0


def test_small_shape_by_hand():
    c = K9.count(SMALL)
    # in: reice, reliq, tavel on 6 cells, tz on 8 levels, tbound on 2
    # columns, semiss 2 x 16; out: absice, absliq, planklay 6 x 16 each,
    # planklev 8 x 16, plankbnd and dplankbnd 2 x 16 each
    read = 4 * (3 * 6 + 8 + 2 + 32)
    written = 4 * 16 * (3 * 6 + 8 + 2 * 2)
    assert (read, written) == (240, 1920)
    assert c == dict(bytes=2160)
    assert least_seconds(c) == pytest.approx(2160 / peaks.HBM_BYTES_PER_S)


def _ctx(ops):
    return SimpleNamespace(
        trace=SimpleNamespace(ops=ops), refresh_windows=[(0.0, 1.0)],
        shapes=[SMALL], bound=lambda stage: least_seconds(K9.count(SMALL)))


def test_the_reader_finds_the_kernel_in_the_trace():
    reader = harness.load_module(
        f"{harness.HERE}/metrics/K9_roofline.py", "bench_metric_K9")
    assert "lw_rows_kernel" in harness.port_kernel_names()
    t = least_seconds(K9.count(SMALL))
    names = [f"void (anonymous namespace)::lw_rows_kernel<{k}>((anonymous "
             f"namespace)::Rows)" for k in (0, 2)]
    # the cloud and the Planck launch, each taking the least time: 50 %
    ops = [(names[0], 0.1, 0.1 + t, "kernel"),
           (names[1], 0.5, 0.5 + t, "kernel"),
           ("void at::native::vectorized_gather_kernel", 0.2, 0.3, "kernel")]
    assert reader.read(_ctx(ops)) == pytest.approx(50.0)
    assert reader.read(_ctx(ops[2:])) is None
