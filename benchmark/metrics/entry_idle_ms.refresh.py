"""entry_idle_ms.refresh (ms): device idle time per captured
radiation_refresh in the profiled stretch, within each `refresh` window
(the call to the end of its synchronise), in the gaps whose innermost
open range is one of the port's "radiation_refresh/<phase>" ranges: the
device waiting on the entry's host phases."""

import entry_trace


def read(ctx):
    return entry_trace.idle_ms(ctx, ctx.refresh_windows,
                              "radiation_refresh")
