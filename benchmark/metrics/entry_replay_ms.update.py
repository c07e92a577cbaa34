"""entry_replay_ms.update (ms): host time of the captured radiation_update
in its `replay` phase, launching the graph's replay and counting its
launches: the lower median of the port's call records
(driver/compiled.py:recent_calls) whose call lies inside one of the
benchmark's `update` spans that end before the profiled stretch."""

import entry_trace


def read(ctx):
    return entry_trace.phase_ms(ctx, "radiation_update", "update",
                               "replay")
