"""K6: RRTMG-SW two-stream and adding solver (spcvmc: reftra and vrtqdr),
clear-sky in every lit column and all-sky in the lit cloudy ones.

Bytes: read the gas and Rayleigh optical depths [lit_cols, nlay, ngpt]
(float32, K5's outputs), the cloud optical depth, single-scattering
albedo and asymmetry (float32) and the cloudy mask (one byte) of the lit
cloudy columns (K2's outputs), the TOA source [lit_cols, ngpt], the
cosine of the zenith angle and the two band albedos [lit_cols, 14];
write the 14 level profiles [lit_cols, nlay+1] (all-sky and clear,
total and direct, broadband, UV and NIR), the six surface UV/PAR/NIR
fluxes and the three band surface fluxes [lit_cols, 14] (float32).

Work: per (column, layer, g-point) and solve (one clear, one all-sky in a
cloudy column), in the PIFM two-stream layer: two exponentials, one
square root and two divisions (five special-function instructions) and
twenty FP32 instructions; in the adding pass per level two divisions
(two) and ten FP32 instructions. The delta scaling is left out.
"""


def count(s):
    g = s["ngpt_sw"]
    solves = (s["lit_cols"] + s["lit_cloudy_cols"]) * s["nlay"] * g
    lit = s["lit_cols"]
    return dict(
        bytes=8 * lit * s["nlay"] * g + 13 * s["lit_cloudy_cols"] * s["nlay"]
        * g + 4 * lit * g + 4 * lit * (1 + 2 * 14)
        + 4 * 14 * lit * (s["nlay"] + 1) + 4 * 6 * lit + 4 * 3 * 14 * lit,
        sfu=7 * solves, fp32=30 * solves)
