"""entry_host_ms.update (ms): host time from the call of the captured
radiation_update to its return, before the synchronise, mean over the
window outside the profiled stretch."""

import harness


def read(ctx):
    return harness.mean_span_ms(ctx, "update")
