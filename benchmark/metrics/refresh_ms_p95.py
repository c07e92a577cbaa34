"""refresh_ms_p95 (ms): the 95th percentile of the refreshes' times, each
from the call to the end of its synchronise on the host clock, over the
window outside the profiled stretch. A refresh of ~50 ms is too short
for the host clock to time it alone to an end-to-end bound, so the tail
stands here, beside refresh_cols_per_s, with no bound."""

import numpy as np


def read(ctx):
    times = [t for i, t in enumerate(ctx.unit_times or [])
             if i not in ctx.profiled]
    return 1e3 * float(np.percentile(times, 95)) if times else None
