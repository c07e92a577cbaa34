"""K5_roofline (%): the share of its roofline that kernel K5, the SW gas
optics (models/rrtmg/taumol_sw_cuda.py, csrc/taumol_sw.cu), reaches in
the profiled refreshes: the least time of the stage's work at their
shapes (roofline/K5.py) over the kernel's device time in them. None
where the kernel did not run."""

import harness


def read(ctx):
    return harness.roofline_share(ctx, "K5", "taumol_sw_kernel")
