"""The roofline counts: they follow the shapes alone, whatever arrays come
with them, and one small shape gives the bytes and instructions worked
out by hand below."""

import numpy as np
import pytest

import program
import scene
from roofline import K1, K2, K3, K4, K5, K6
from roofline.peaks import least_seconds

STAGES = (K1, K2, K3, K4, K5, K6)
CONFIG = dict(ngpt_lw=140, ngpt_sw=112, nband_lw=16, nband_sw=14,
              solar_dt=3600.0)
# 2 columns of 3 layers: both cloudy, the first through layer 2 (3 layers
# from the top), the second through layer 1 (2); the first alone lit
SMALL = dict(ncol=2, nlay=3, ngpt_lw=140, ngpt_sw=112, nband_lw=16,
             nband_sw=14, cloudy_cols=2, cloudy_depth_lw=5, lit_cols=1,
             lit_cloudy_cols=1, cloudy_depth_sw=3)


@pytest.mark.parametrize("stage", STAGES, ids=lambda m: m.__name__)
def test_the_count_follows_the_shapes_alone(stage):
    arrays = scene.scene(32, 72, 3)
    s = program.refresh_shapes(arrays, CONFIG, 172.5, 12.0)
    other = dict(s, taug=np.ones((32, 72, 140)), fcld=arrays["fcld"] * 0.5)
    assert stage.count(s) == stage.count(other)
    assert least_seconds(stage.count(s)) > 0.0


def test_the_shapes_follow_cloud_and_sunlight():
    arrays = scene.scene(32, 72, 3)
    s = program.refresh_shapes(arrays, CONFIG, 172.5, 12.0)
    cloudy = (arrays["fcld"] > 0).any(axis=1)
    assert s["cloudy_cols"] == int(cloudy.sum())
    assert 0 < s["lit_cols"] < 32
    assert s["cloudy_depth_lw"] <= 72 * s["cloudy_cols"]
    arrays["fcld"][:] = 0.0
    assert program.refresh_shapes(arrays, CONFIG, 172.5, 12.0)[
        "cloudy_depth_lw"] == 0


def test_small_shape_by_hand():
    c = K1.count(SMALL)
    draws = 4 * 5 * 140
    assert c["alu"] == draws * 43 and c["iadd"] == draws * 27
    assert c["fp32"] == draws
    # cldf 6 cells, six fields of the 2 cloudy columns' 3 layers, taucmc,
    # the mask, the counts
    assert c["bytes"] == 4 * 6 + 24 * 6 + 4 * 6 * 140 + 6 + 32
    c = K2.count(SMALL)
    assert c["alu"] == 4 * 3 * 112 * 43
    assert c["bytes"] == 4 * 3 + 24 * 3 + 13 * 3 * 112 + 16
    assert K3.count(SMALL) == dict(bytes=36 * 6 + 8 * 6 * 140,
                                   fp32=6 * 6 * 140)
    c = K4.count(SMALL)
    assert c["sfu"] == c["fp32"] == (2 + 2) * 3 * 140
    assert c["bytes"] == (8 * 6 * 140 + 4 * 2 * 3 * 140 + 4 * (12 + 2)
                          + 64 * 2 + 24 * 2 * 4 + 128 * 2)
    assert K5.count(SMALL) == dict(bytes=36 * 3 + 8 * 3 * 112,
                                   fp32=5 * 3 * 112)
    c = K6.count(SMALL)
    assert c["sfu"] == 7 * 2 * 3 * 112 and c["fp32"] == 30 * 2 * 3 * 112
    assert c["bytes"] == (8 * 3 * 112 + 13 * 3 * 112 + 4 * 112 + 4 * 29
                          + 4 * 14 * 4 + 24 + 4 * 42)
    # K1 here is bound by the ALU pipe: 64 lanes per SM and clock
    from roofline import peaks
    assert least_seconds(K1.count(SMALL)) == pytest.approx(
        draws * 43 / peaks.ALU_PER_S)
