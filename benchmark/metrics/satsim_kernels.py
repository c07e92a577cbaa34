"""satsim_kernels (kernels): the kernels launched per COSP call in the
profiled stretch, between the benchmark's `satsim` span and the end of
its synchronise; most are the radar's elementwise passes over its
[points, subcolumns, levels, 85] DSD planes."""

import satsim_trace


def read(ctx):
    return satsim_trace.kernels(ctx)
