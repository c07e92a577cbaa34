"""satsim_host_ms (ms): host time per COSP call in the captured
cosp_simulator entry: the port's call records (driver/compiled.py:
recent_calls) inside the benchmark's `satsim` spans that end before the
profiled stretch, every phase of a call summed, the lower median over
the calls."""

import satsim_trace


def read(ctx):
    return satsim_trace.host_ms(ctx)
