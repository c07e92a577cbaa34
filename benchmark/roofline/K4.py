"""K4: RRTMG-LW radiative transfer (rtrnmc): the diffusivity-angle
downward and upward sweeps, clear and all-sky, with the surface
temperature derivatives.

Bytes: read the gas optical depth and Planck fraction [ncol, nlay, ngpt]
(float32, K3's outputs) in every column and the cloud optical depth
(float32, K1's output) in the cloudy ones, the layer and level
temperatures, surface temperature and band emissivities; write the six
level profiles (all-sky and clear up and down, and the two upward
derivatives) [ncol, nlay+1] and the band OLR and its derivative
[ncol, 16] (float32).

Work: per (column, layer, g-point) one exponential of the clear optical
depth (one special-function instruction and one FP32 scaling), and one
more of the all-sky depth in a cloudy column; the source terms and the
sweeps' sums are left out.
"""


def count(s):
    cells = s["ncol"] * s["nlay"]
    g = s["ngpt_lw"]
    exps = (s["ncol"] + s["cloudy_cols"]) * s["nlay"] * g
    return dict(bytes=8 * cells * g + 4 * s["cloudy_cols"] * s["nlay"] * g
                + 4 * (2 * cells + s["ncol"]) + 4 * 16 * s["ncol"]
                + 6 * 4 * s["ncol"] * (s["nlay"] + 1) + 2 * 4 * 16 * s["ncol"],
                sfu=exps, fp32=exps)
