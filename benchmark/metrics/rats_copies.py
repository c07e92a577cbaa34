"""rats_copies (ops): per RATS refresh, the tensors copied in, scalars
filled and tensors cloned out by its captured rrtmg_lw solves (the key
of the calls inside the `rats` spans before the profiled stretch,
driver/compiled.py:counts, times the solves a refresh makes), plus the
zero fills and stacked copies of rats_refresh and rats_update
(driver/diagnostics.py:counts)."""

import rats_trace


def read(ctx):
    return rats_trace.copies(ctx)
