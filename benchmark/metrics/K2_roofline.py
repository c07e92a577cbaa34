"""K2_roofline (%): the share of its roofline that kernel K2, the fused
McICA subcolumns and SW cloud optics (ops/mcica_cuda.py,
csrc/mcica_sw.cu), reaches in the profiled refreshes: the least time of
the stage's work at their shapes (roofline/K2.py) over the kernel's
device time in them. None where the kernel did not run."""

import harness


def read(ctx):
    return harness.roofline_share(ctx, "K2", "mcica_sw_kernel")
