"""K11: QuickBeam's DSD integrals, path integral and dBZe, one COSP call's
radar over every point, subcolumn and level.

Bytes: read the mixing ratios of the 5 classes GEOS fills (liquid, ice,
rain, snow and graupel; [5, points, subcolumns, levels] float32) and the
height, pressure, temperature and gas-path profiles [points, levels]
once; write dbze, ze_non and h_atten [points, subcolumns, levels] once.

Left out: the radii, which the work needs only where a class is present
(K11 reads them all: csrc/quickbeam.cu says why), and the size work (85
sizes of N(D) a present class), whose amount SCOPS's draws decide and
the shapes do not carry: counting them could pass 100 %. So the count
is a floor of the bytes alone.

The shapes of one call: `ncol` (points) and `nlay` (levels) of the
profiled refresh, `subcolumns` those of the radar's call (the reader
takes them from the port's radar counter).
"""

CLASSES = 5
PROFILES = 4
OUTPUTS = 3


def count(s):
    points, levels, sub = s["ncol"], s["nlay"], s["subcolumns"]
    volumes = points * sub * levels
    read = 4 * (CLASSES * volumes + PROFILES * points * levels)
    written = 4 * OUTPUTS * volumes
    return dict(bytes=read + written)
