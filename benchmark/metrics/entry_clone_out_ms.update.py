"""entry_clone_out_ms.update (ms): host time of the captured
radiation_update in its `clone_out` phase, cloning the static outputs:
the lower median of the port's call records
(driver/compiled.py:recent_calls) whose call lies inside one of the
benchmark's `update` spans that end before the profiled stretch."""

import entry_trace


def read(ctx):
    return entry_trace.phase_ms(ctx, "radiation_update", "update",
                               "clone_out")
