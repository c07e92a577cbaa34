"""K3: RRTMG-LW gas optics (taumol_lw): the optical depth and the Planck
fraction of every g-point in every layer, 140 g-points.

Bytes: read per (column, layer) the layer's pressure and temperature and
seven absorber amounts (H2O, CO2, O3, N2O, CH4, O2 and the broadening
gases), float32; write the gas optical depth and the Planck fraction
[ncol, nlay, ngpt] (float32).

Work: per (column, layer, g-point) the two-point interpolation in
pressure and temperature of the major absorber (four FMAs) and of the
Planck fraction (two): six FP32 instructions. The minor absorbers and
the water continua are left out.
"""


def count(s):
    cells = s["ncol"] * s["nlay"]
    return dict(bytes=9 * 4 * cells + 8 * cells * s["ngpt_lw"],
                fp32=6 * cells * s["ngpt_lw"])
