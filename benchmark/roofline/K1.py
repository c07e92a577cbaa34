"""K1: RRTMG-LW McICA subcolumns and cloud optical depth (mcica_subcol_lw
with cldprmc), 140 g-points.

Work: four threefry uniforms per (subcolumn, layer) of every cloudy
column, from the top through its lowest cloudy layer: presence and its
overlap draw, condensate and its correlation draw (the overlap chain of a
cloudy layer reads the draws of the layers above it; nothing below the
lowest cloud and nothing in a clear column needs a draw). The
presence tests, fills and the band-to-g optical depth are left out.

Bytes: read cloud fraction in every column, and the in-cloud ice and
liquid paths, effective radii and the two overlap parameters in the
cloudy ones (float32 per layer); write the optical depth [ncol, nlay,
ngpt] (float32, dense: zero in clear subcolumns), the cloudy-layer mask
(one byte per layer) and the four clear-subcolumn counts (int32).
"""

from .peaks import add, uniforms


def count(s):
    cells = s["ncol"] * s["nlay"]
    return add(uniforms(4 * s["cloudy_depth_lw"] * s["ngpt_lw"]), dict(
        bytes=4 * cells + 6 * 4 * s["cloudy_cols"] * s["nlay"]
        + 4 * cells * s["ngpt_lw"] + cells + 16 * s["ncol"]))
