"""K2: RRTMG-SW McICA subcolumns and delta-scaled cloud optics
(mcica_subcol_sw with cldprmc_sw), 112 g-points, over the lit columns.

Work: four threefry uniforms per (subcolumn, layer) of every lit cloudy
column, from the top through its lowest cloudy layer (as K1). The band
optics of ice and liquid (per layer and band) and the delta scaling are
left out.

Bytes: read cloud fraction in every lit column, and the in-cloud paths,
effective radii and overlap parameters in the lit cloudy ones (float32
per layer); write optical depth, single-scattering albedo and asymmetry
(float32) and the cloudy mask (one byte) per (lit column, layer,
g-point), and the four clear-subcolumn counts (int32) per lit column.
"""

from .peaks import add, uniforms


def count(s):
    lit = s["lit_cols"] * s["nlay"]
    return add(uniforms(4 * s["cloudy_depth_sw"] * s["ngpt_sw"]), dict(
        bytes=4 * lit + 6 * 4 * s["lit_cloudy_cols"] * s["nlay"]
        + 13 * lit * s["ngpt_sw"] + 16 * s["lit_cols"]))
