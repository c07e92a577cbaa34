"""entry_copy_in_ms.update (ms): host time of the captured radiation_update
in its `copy_in` phase, copying the call's tensors and scalars into the
key's static buffers (StaticIO.load): the mean of the port's call
records (driver/compiled.py:recent_calls) whose call lies inside one of
the benchmark's `update` spans that end before the profiled stretch."""

import entry_trace


def read(ctx):
    return entry_trace.phase_ms(ctx, "radiation_update", "update",
                               "copy_in")
