"""entry_copy_in_ms.refresh (ms): host time of the captured
radiation_refresh in its `copy_in` phase, copying the call's tensors and
scalars into the key's static buffers (StaticIO.load): the lower median
of the port's call records (driver/compiled.py:recent_calls) whose call
lies inside one of the benchmark's `refresh` spans that end before the
profiled stretch (only two in rrtmgp.refresh_c90, where it is the lower
of the two)."""

import entry_trace


def read(ctx):
    return entry_trace.phase_ms(ctx, "radiation_refresh", "refresh",
                               "copy_in")
