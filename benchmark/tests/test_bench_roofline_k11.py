"""K11's roofline count and the reader of K11_roofline: the count follows
the shapes alone (points and levels of the refresh, the radar's
subcolumns); one small shape gives the bytes worked out by hand; the
reader takes the kernel's device time from a synthetic trace's `satsim`
windows with the subcolumns of the port's radar counter, or reads
nothing where the kernel did not run, where windows and refreshes differ
in number, or where the counter names no one subcolumn count at the
refreshes' points."""

from types import SimpleNamespace

import pytest

import harness
import program
import scene
from roofline import K11, peaks
from roofline.peaks import least_seconds

CONFIG = dict(ngpt_lw=140, ngpt_sw=112, nband_lw=16, nband_sw=14,
              solar_dt=3600.0)
SMALL = dict(ncol=2, nlay=3, ngpt_lw=140, ngpt_sw=112, nband_lw=16,
             nband_sw=14, cloudy_cols=2, cloudy_depth_lw=5, lit_cols=1,
             lit_cloudy_cols=1, cloudy_depth_sw=3)


def _counts(*shapes):
    """radar.counts() after K11's calls at [points, subcolumns, levels]."""
    return {((0, 1, 2, 3, 6), s, "torch.float32"): dict(
        blocks=1, points_per_block=s[0], classes=5, points=s[0],
        plane_bytes=0, kernel=True, present=7) for s in shapes}


def test_the_count_follows_the_shapes_alone():
    arrays = scene.scene(32, 72, 3)
    s = dict(program.refresh_shapes(arrays, CONFIG, 172.5, 12.0),
             subcolumns=50)
    other = dict(s, cloudy_cols=0, lit_cols=0, lit_cloudy_cols=0,
                 cloudy_depth_sw=0, fcld=arrays["fcld"] * 0.5)
    assert K11.count(s) == K11.count(other)
    assert K11.count(s) != K11.count(dict(s, subcolumns=16))
    assert least_seconds(K11.count(s)) > 0.0


def test_small_shape_by_hand():
    c = K11.count(dict(SMALL, subcolumns=4))
    # 2 points x 4 subcolumns x 3 levels: 24 volumes
    # in: 5 classes' mixing ratios, 24 each, and four profiles of 2 x 3;
    # out: dbze, ze_non and h_atten, 24 each
    read = 4 * (5 * 24 + 4 * 6)
    written = 4 * 3 * 24
    assert (read, written) == (576, 288)
    assert c == dict(bytes=864)
    assert least_seconds(c) == pytest.approx(864 / peaks.HBM_BYTES_PER_S)


def test_subcolumns_from_the_ports_radar_counter(monkeypatch):
    from geosradiation_gridcomp_tpu_torch.satsim import radar
    reader = _reader()
    ctx = _ctx([])
    monkeypatch.setattr(radar, "counts", lambda: _counts((2, 50, 3)))
    assert reader.subcolumns(ctx) == 50
    monkeypatch.setattr(radar, "counts",
                        lambda: _counts((2, 50, 3), (6, 16, 3)))
    assert reader.subcolumns(ctx) == 50
    monkeypatch.setattr(radar, "counts", lambda: _counts((6, 16, 3)))
    assert reader.subcolumns(ctx) is None
    monkeypatch.setattr(radar, "counts",
                        lambda: _counts((2, 50, 3), (2, 16, 3)))
    assert reader.subcolumns(ctx) is None
    monkeypatch.delattr(radar, "counts")
    assert reader.subcolumns(ctx) is None


def _reader():
    return harness.load_module(f"{harness.HERE}/metrics/K11_roofline.py",
                               "bench_metric_K11")


def _ctx(ops, windows=2):
    ranges = []
    for i in range(windows):
        t = 10.0 + i
        ranges += [("refresh", t, t + 0.01), ("sync", t + 0.01, t + 0.02),
                   ("satsim", t + 0.1, t + 0.11),
                   ("sync", t + 0.11, t + 0.6)]
    return SimpleNamespace(
        trace=SimpleNamespace(ops=ops, ranges=ranges),
        shapes=[SMALL, SMALL])


def test_the_reader_finds_the_kernel_in_the_trace(monkeypatch):
    from geosradiation_gridcomp_tpu_torch.satsim import radar
    reader = _reader()
    monkeypatch.setattr(radar, "counts", lambda: _counts((2, 50, 3)))
    assert "quickbeam_kernel" in harness.port_kernel_names()
    t = least_seconds(K11.count(dict(SMALL, subcolumns=50)))
    name = "void (anonymous namespace)::quickbeam_kernel<false>(" \
        "(anonymous namespace)::Args)"
    # one launch in each window, each four times the least time: 25 %; a
    # launch outside the windows and another kernel do not count
    ops = [(name, 10.2, 10.2 + 4 * t, "kernel"),
           (name, 11.2, 11.2 + 4 * t, "kernel"),
           (name, 12.5, 12.6, "kernel"),
           ("void at::native::vectorized_elementwise_kernel", 10.3, 10.4,
            "kernel")]
    assert reader.read(_ctx(ops)) == pytest.approx(25.0)
    assert reader.read(_ctx(ops[3:])) is None
    assert reader.read(_ctx(ops, windows=1)) is None
    monkeypatch.setattr(radar, "counts", dict)
    assert reader.read(_ctx(ops)) is None
