"""K6_roofline (%): the share of its roofline that kernel K6, the SW two-
stream solver (models/rrtmg/spcvmc_cuda.py, csrc/spcvmc.cu), reaches in
the profiled refreshes: the least time of the stage's work at their
shapes (roofline/K6.py) over the kernel's device time in them. None
where the kernel did not run."""

import harness


def read(ctx):
    return harness.roofline_share(ctx, "K6", "spcvmc_kernel")
