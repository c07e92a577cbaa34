"""K8's roofline count and the reader of K8_roofline: the count follows
the shapes alone, one small shape gives the bytes and instructions worked
out by hand, and the reader takes the kernel's device time from the
trace, or reads nothing where the kernel did not run."""

from types import SimpleNamespace

import numpy as np
import pytest

import harness
import program
import scene
from roofline import K8, peaks
from roofline.peaks import least_seconds

CONFIG = dict(ngpt_lw=140, ngpt_sw=112, nband_lw=16, nband_sw=14,
              solar_dt=3600.0)
# 2 columns of 3 layers: both cloudy, the first through layer 2 (3 layers
# from the top), the second through layer 1 (2); the first alone lit
SMALL = dict(ncol=2, nlay=3, ngpt_lw=140, ngpt_sw=112, nband_lw=16,
             nband_sw=14, cloudy_cols=2, cloudy_depth_lw=5, lit_cols=1,
             lit_cloudy_cols=1, cloudy_depth_sw=3)


def test_the_count_follows_the_shapes_alone():
    arrays = scene.scene(32, 72, 3)
    s = program.refresh_shapes(arrays, CONFIG, 172.5, 12.0)
    other = dict(s, taug=np.ones((32, 72, 140)), fcld=arrays["fcld"] * 0.5)
    assert K8.count(s) == K8.count(other)
    assert least_seconds(K8.count(s)) > 0.0


def test_small_shape_by_hand():
    c = K8.count(SMALL)
    # LW: 4 draws in each of the 5 cloudy-depth layers, less the two
    # correlation draws of each column's top layer; SW: the lit column's
    # 3 layers, less its top layer's two
    draws = 140 * (4 * 5 - 2 * 2) + 112 * (4 * 3 - 2 * 1)
    assert draws == 3360
    assert c["alu"] == draws * 43 and c["iadd"] == draws * 27
    assert c["fp32"] == draws
    # cldf and zm on 6 cells, play's lowest four layers of 2 columns,
    # mask and zcw of every cell for 140 + 112 g-points
    assert c["bytes"] == 4 * 6 + 4 * 6 + 16 * 2 + 5 * 6 * (140 + 112)
    # bound by the ALU pipe: 64 lanes per SM and clock
    assert least_seconds(c) == pytest.approx(draws * 43 / peaks.ALU_PER_S)


def test_small_shape_by_hand_without_condensate_chain():
    c = K8.count(dict(SMALL, condensate_inhomogeneity=0))
    # the presence draw in each cloudy-depth layer and its correlation
    # draw in each but a column's top one: LW 2 x 5 - 2, SW 2 x 3 - 1
    draws = 140 * (2 * 5 - 2) + 112 * (2 * 3 - 1)
    assert draws == 1680
    assert c["alu"] == draws * 43 and c["fp32"] == draws
    assert c["bytes"] == K8.count(SMALL)["bytes"]
    assert K8.count(dict(SMALL, condensate_inhomogeneity=2)) == K8.count(
        SMALL)


def _ctx(ops):
    window = (0.0, 1.0)
    return SimpleNamespace(
        trace=SimpleNamespace(ops=ops), refresh_windows=[window],
        shapes=[SMALL],
        bound=lambda stage: least_seconds(K8.count(SMALL)))


def test_the_reader_finds_the_kernel_in_the_trace():
    reader = harness.load_module(
        f"{harness.HERE}/metrics/K8_roofline.py", "bench_metric_K8")
    assert "mcica_gmr_kernel" in harness.port_kernel_names()
    t = least_seconds(K8.count(SMALL))
    name = ("(anonymous namespace)::mcica_gmr_kernel(float const*, float "
            "const*, float const*, float const*, float const*, unsigned "
            "char*, float*, int, int, int)")
    # the SW and LW launches, each taking the least time: 50 %
    ops = [(name, 0.1, 0.1 + t, "kernel"), (name, 0.5, 0.5 + t, "kernel"),
           ("void at::native::elementwise_kernel", 0.2, 0.3, "kernel")]
    assert reader.read(_ctx(ops)) == pytest.approx(50.0)
    assert reader.read(_ctx(ops[2:])) is None
