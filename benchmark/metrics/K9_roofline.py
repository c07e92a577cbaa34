"""K9_roofline (%): the share of its roofline that kernel K9, the LW
table rows (models/rrtmg/lw_rows_cuda.py, csrc/lw_rows.cu), reaches in
the profiled refreshes, over its cloud and Planck launches: the least
time of the stage's work at their shapes (roofline/K9.py) over the
kernel's device time in them. None where the kernel did not run."""

import harness


def read(ctx):
    return harness.roofline_share(ctx, "K9", "lw_rows_kernel")
