"""entry_idle_ms.update (ms): device idle time per captured
radiation_update in the profiled stretch, within each `update` window
(the call to the end of its synchronise), in the gaps whose innermost
open range is one of the port's "radiation_update/<phase>" ranges: the
device waiting on the entry's host phases."""

import entry_trace


def read(ctx):
    return entry_trace.idle_ms(ctx, ctx.update_windows, "radiation_update")
