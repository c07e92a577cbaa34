"""rats_host_ms (ms): host time per RATS refresh in the captured rrtmg_lw
entry: the port's call records (driver/compiled.py:recent_calls) inside
each of the benchmark's `rats` spans that end before the profiled
stretch, every phase of every call summed per span, the lower median
over the spans."""

import rats_trace


def read(ctx):
    return rats_trace.host_ms(ctx)
