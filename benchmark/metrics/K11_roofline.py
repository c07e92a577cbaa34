"""K11_roofline (%): the share of its roofline that kernel K11, the COSP
radar's DSD integrals (satsim/radar_cuda.py, csrc/quickbeam.cu), reaches
in the profiled COSP calls: the least time of its bytes at the profiled
refreshes' shapes with the radar's subcolumns (roofline/K11.py) over the
kernel's device time in the `satsim` windows. None where the kernel did
not run, where the windows and the profiled refreshes differ in number,
or where the port's radar counter names no one subcolumn count at the
refreshes' points."""

import harness
import satsim_trace
from roofline import K11
from roofline.peaks import least_seconds


def subcolumns(ctx):
    """The subcolumns of the radar's calls at the points of the profiled
    refreshes, by the port's radar counter (satsim/radar.py:counts), whose
    keys carry each call's [points, subcolumns, levels]; None without the
    counter, or where it holds no such call or calls of more than one
    subcolumn count."""
    from geosradiation_gridcomp_tpu_torch.satsim import radar
    counts = getattr(radar, "counts", None)
    if counts is None or not ctx.shapes:
        return None
    points = ctx.shapes[0]["ncol"]
    sub = {key[1][1] for key, c in counts().items() if c["points"] == points}
    return sub.pop() if len(sub) == 1 else None


def read(ctx):
    w = satsim_trace.windows(ctx)
    if not w or len(w) != len(ctx.shapes):
        return None
    t = harness.device_time_within(
        [o for o in ctx.trace.ops if o[3] == "kernel"
         and harness.kernel_base(o[0]) == "quickbeam_kernel"], w)
    sub = subcolumns(ctx)
    if t <= 0.0 or not sub:
        return None
    bound = sum(least_seconds(K11.count(dict(s, subcolumns=sub)))
                for s in ctx.shapes)
    return 100.0 * bound / t
