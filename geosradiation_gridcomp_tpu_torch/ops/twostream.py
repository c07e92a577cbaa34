"""Delta-Eddington two-stream layer optics (the reference's `deledd`).

Port of geosradiation_gridcomp_tpu/ops/twostream.py: sorad.F90:1592-1706
(King & Harshvardhan 1986 closed form), elementwise over any batch of
(tau, ssa, g, mu0). Float32 throughout, with the reference's widened
zenith-angle nudge around the removable singularity at akk*mu0 -> 1
(sorad.F90:1661-1668).
"""

import torch


def deledd(tau, ssc, g0, zth, thresh=1e-3):
    """Delta-Eddington reflection/transmission of a homogeneous layer.

    Args:
      tau: optical thickness
      ssc: single-scattering albedo (< 1)
      g0: asymmetry factor
      zth: cosine of incidence angle (a tensor, or a Python float)
      All broadcastable to a common shape.

    Returns:
      (rr, tt, td): reflection of the direct beam, total (direct+diffuse)
      transmission, direct transmission.
    """
    ff = g0 * g0
    xx = 1.0 - ff * ssc
    taup = tau * xx
    sscp = ssc * (1.0 - ff) / xx
    gp = g0 / (1.0 + g0)

    x3 = 3.0 * gp
    gm1 = (7.0 - sscp * (4.0 + x3)) * 0.25
    gm2 = -(1.0 - sscp * (4.0 - x3)) * 0.25

    akk = torch.sqrt(torch.clamp((gm1 + gm2) * (gm1 - gm2), min=1e-30))

    # nudge zth away from the akk*zth == 1 resonance (removable singularity)
    st3_test = 1.0 - (akk * zth) ** 2
    if isinstance(zth, torch.Tensor):
        nudged = torch.where(zth + 0.001 > 1.0, zth - 0.001, zth + 0.001)
    else:
        nudged = zth - 0.001 if zth + 0.001 > 1.0 else zth + 0.001
    zth_n = torch.where(torch.abs(st3_test) < thresh, nudged, zth)
    xx = akk * zth_n
    st7 = 1.0 - xx
    st8 = 1.0 + xx
    st3 = st7 * st8

    td = torch.exp(-taup / zth_n)

    gm3 = (2.0 - zth_n * 3.0 * gp) * 0.25
    xx = gm1 - gm2
    alf1 = gm1 - gm3 * xx
    alf2 = gm2 + gm3 * xx

    xx = akk * 2.0
    all_ = (gm3 - alf2 * zth_n) * xx * td
    bll = (1.0 - gm3 + alf1 * zth_n) * xx

    xx = akk * gm3
    cll = (alf2 + xx) * st7
    dll = (alf2 - xx) * st8

    xx = akk * (1.0 - gm3)
    fll = (alf1 + xx) * st8
    ell = (alf1 - xx) * st7

    st2 = torch.exp(-akk * taup)
    st4 = st2 * st2

    st1 = sscp / ((akk + gm1 + (akk - gm1) * st4) * st3)

    rr = torch.clamp((cll - dll * st4 - all_ * st2) * st1, min=0.0)
    tt = torch.clamp(-((fll - ell * st4) * td - bll * st2) * st1, min=0.0)
    tt = tt + td
    return rr, tt, td
