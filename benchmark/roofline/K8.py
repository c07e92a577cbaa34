"""K8: RRTMGP's McICA draws (GEN_MAX_RAN_OVERLAP with condensate
inhomogeneity), the cloud mask and zcw of every g-point, for the SW
(112 g-points) and the LW (140) in turn.

Work: threefry uniforms per g-point of every cloudy column, from the top
through its lowest cloudy layer (nothing below it and nothing in a clear
column needs a draw): the presence and condensate draws in each of those
layers and their two correlation draws in each but the top one, which
keeps its own draws whatever the correlation draws read, so 4 * depth - 2
per (column, g-point). Without condensate inhomogeneity (the shapes'
condensate_inhomogeneity 0) there is no condensate chain: 2 * depth - 1.
The shapes of today's loops do not carry that key, and every cell that
reports K8_roofline runs with inhomogeneity 1, which is what its absence
means here. The LW counts every cloudy column, the SW the lit ones. The
chains, the mask tests and the zcw lookup are left out.

Bytes: read the cloud fraction and the mid-layer heights (float32 per
layer) and the pressures of the lowest four layers (the columns' seeds)
once; write the mask (one byte) and zcw (float32) per (column, layer,
g-point) of the SW and of the LW.
"""

from .peaks import add, uniforms


def count(s):
    cells = s["ncol"] * s["nlay"]
    # draws per layer: presence and its correlation, and as many for the
    # condensate where it has a chain
    k = 4 if s.get("condensate_inhomogeneity", 1) != 0 else 2
    draws = (s["ngpt_lw"] * (k * s["cloudy_depth_lw"]
                             - k // 2 * s["cloudy_cols"])
             + s["ngpt_sw"] * (k * s["cloudy_depth_sw"]
                               - k // 2 * s["lit_cloudy_cols"]))
    return add(uniforms(draws), dict(
        bytes=8 * cells + 16 * s["ncol"]
        + 5 * cells * (s["ngpt_lw"] + s["ngpt_sw"])))
