"""satsim_device_ms (ms): device time per COSP call in the profiled
stretch, every operation that starts between the benchmark's `satsim`
span and the end of its synchronise: the replay of the captured
cosp_simulator graph (SCOPS, the five simulators, their statistics)."""

import satsim_trace


def read(ctx):
    return satsim_trace.device_ms(ctx)
