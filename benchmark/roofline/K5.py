"""K5: RRTMG-SW gas optics (taumol_sw): the gas and Rayleigh optical
depths of every g-point in every layer of the lit columns, 112 g-points.

Bytes: read per (lit column, layer) the layer's pressure and temperature
and seven absorber amounts (float32); write the gas and Rayleigh optical
depths [lit_cols, nlay, ngpt] (float32). Dark columns need no SW.

Work: per (lit column, layer, g-point) the two-point interpolation in
pressure and temperature of the major absorber (four FMAs) and the
Rayleigh term (one): five FP32 instructions.
"""


def count(s):
    cells = s["lit_cols"] * s["nlay"]
    return dict(bytes=9 * 4 * cells + 8 * cells * s["ngpt_sw"],
                fp32=5 * cells * s["ngpt_sw"])
