"""K3_roofline (%): the share of its roofline that kernel K3, the LW gas
optics (models/rrtmg/taumol_lw_cuda.py, csrc/taumol_lw.cu), reaches in
the profiled refreshes: the least time of the stage's work at their
shapes (roofline/K3.py) over the kernel's device time in them. None
where the kernel did not run."""

import harness


def read(ctx):
    return harness.roofline_share(ctx, "K3", "taumol_lw_kernel")
