"""satsim_plane_gib (GiB): the bytes of the radar's [block, subcolumns,
levels, 85] float32 N(D) planes, one a class and block, that one COSP
call at the cell's points materialises, by the port's radar counter
(satsim/radar.py:counts)."""

import satsim_trace


def read(ctx):
    return satsim_trace.plane_gib(ctx)
