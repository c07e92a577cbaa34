"""K9: the LW table rows, the linear interpolations in the rows of the
small LW tables (one float per LW band): the cloud absorption rows of ice
and liquid at the particle sizes, and the Planck rows at the layer, level
and surface temperatures.

Bytes: read reice, reliq and tavel [ncol, nlay], tz [ncol, nlay+1], tbound
[ncol] and semiss [ncol, nband] (float32) once; write absice, absliq and
planklay [ncol, nlay, nband], planklev [ncol, nlay+1, nband], plankbnd
and dplankbnd [ncol, nband] (float32) once. The shapes do not carry the
LW solve's dudts, without which the kernel writes no dplankbnd: it is
counted all the same, 64 B a column, under 0.4 % of the total. The
tables (under 40 KB) are left out, and so is the arithmetic (three FP32
operations per output float, far below the bytes' time).
"""


def count(s):
    ncol, nlay, nb = s["ncol"], s["nlay"], s["nband_lw"]
    cells, levels = ncol * nlay, ncol * (nlay + 1)
    read = 4 * (3 * cells + levels + ncol + nb * ncol)
    written = 4 * nb * (3 * cells + levels + 2 * ncol)
    return dict(bytes=read + written)
