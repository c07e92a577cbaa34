"""K1_roofline (%): the share of its roofline that kernel K1, the fused
McICA subcolumns and LW cloud optical depth (ops/mcica_cuda.py,
csrc/mcica_lw.cu), reaches in the profiled refreshes: the least time of
the stage's work at their shapes (roofline/K1.py) over the kernel's
device time in them. None where the kernel did not run."""

import harness


def read(ctx):
    return harness.roofline_share(ctx, "K1", "mcica_lw_kernel")
