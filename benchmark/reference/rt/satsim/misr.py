"""MISR simulator: stereo cloud-top-height x optical-depth histograms.

Port of geosradiation_gridcomp_tpu/satsim/misr.py (MISR_simulator.f:
1-473). The per-level CTH state machine (first-cloud trigger,
penetration-height update, distinctive-water-layer / thick-column
termination) is a loop over levels carrying four [np, nsub] states with
(point, subcolumn) lanes vectorized; the neighbor-matching "pattern
matcher" adjustment and the 7 x 16 tau-CTH histogram are masked vector
ops.
"""

import numpy as np
import torch

from ..tables import on_device
from .icarus import MISSING, TAU_EDGES, _TAUCHK, digitize, histogram

N_MISR_CTH = 16
# CTH bin boundaries [km] (MISR_simulator.f DATA MISR_CTH_boundaries);
# bin 0 = "detected, no height", bins 1..15 by height
CTH_BOUNDARIES_KM = np.array([-99., 0., 0.5, 1., 1.5, 2., 2.5, 3.,
                              4., 5., 7., 9., 11., 13., 15., 17., 99.])


def _cth_bin(z_m):
    """MISR CTH bin index (0-based into the 16 bins) for a height in m:
    iMISR_ztop=2 + count(z > 1000*bound[l+1], l=2..16) in Fortran, i.e.
    1-based bin 2..16 -> 0-based 1..15."""
    edges = on_device(1000.0 * CTH_BOUNDARIES_KM[2:-1], z_m.device,
                      z_m.dtype)                                # 14 edges
    return 1 + (z_m[..., None] > edges).sum(dim=-1)


def misr_simulator(frac_out, zfull, at, dtau_s, dtau_c, sunlit):
    """MISR CTH-tau joint histogram + summary diagnostics.

    Args:
      frac_out: [np, ncol, nlev] int (0/1/2) subcolumn codes (TOA-first).
      zfull: [np, nlev] layer mid heights (m); at: [np, nlev] temperature.
      dtau_s/dtau_c: [np, nlev] in-cloud visible optical depths.
      sunlit: [np] 1/0.

    Returns dict: fq_misr [np, 7, 16] (tau x CTH), cldarea, mean_ztop
    [np], dist_model_layertops [np, 16], box_misr_ztop [np, ncol].
    """
    npnt, ncol, nlev = frac_out.shape
    dtype, dev = zfull.dtype, zfull.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    missing = torch.full((), MISSING, dtype=dtype, device=dev)

    # distribution of model layer tops over MISR bins (f:99-123)
    ztest = torch.cat([zfull[:, :1], 0.5 * (zfull[:, 1:-1] + zfull[:, :-2]),
                       zfull[:, -1:]], dim=-1)
    top_bins = _cth_bin(ztest)          # [np, nlev]
    dist_tops = torch.zeros((npnt, N_MISR_CTH), dtype=dtype, device=dev)
    dist_tops.scatter_add_(1, top_bins, torch.ones_like(zfull))

    # per-subcolumn layer optical depth
    dtau = torch.where(frac_out == 1, dtau_s[:, None, :],
                       torch.where(frac_out == 2, dtau_c[:, None, :], zero))

    # layer-top-interpolated penetration height for the OD=1 rule
    # (f:186-197): 0.5*(z_l + z_{l-1}) - 0.5*(z_{l-1} - z_{l+1})/dtau
    z_prev = torch.cat([zfull[:, :1], zfull[:, :-1]], dim=-1)
    z_next = torch.cat([zfull[:, 1:], zfull[:, -1:]], dim=-1)

    shape = (npnt, ncol)
    crossed = torch.zeros(shape, dtype=torch.int32, device=dev)
    cloud_dtau = torch.zeros(shape, dtype=dtype, device=dev)
    tau = torch.zeros(shape, dtype=dtype, device=dev)
    ztop = torch.zeros(shape, dtype=dtype, device=dev)
    one_i = torch.ones((), dtype=torch.int32, device=dev)
    for lev in range(nlev):
        d = dtau[..., lev]
        z, zp, zn = zfull[:, lev], z_prev[:, lev], z_next[:, lev]
        edge = lev in (0, nlev - 1)
        tau = tau + d
        # first cloud encountered starts the counter (f:160-166)
        start = (crossed == 0) & (d > 0.0)
        crossed = torch.where(start, one_i, crossed)
        cloud_dtau = torch.where(start, zero, cloud_dtau)
        active = (crossed > 0) & (crossed < 99)
        # continuity counter (f:169-181)
        new_cdtau = torch.where(d == 0.0, zero, cloud_dtau + d)
        cloud_dtau = torch.where(active, new_cdtau, cloud_dtau)
        # penetration height when cloud above this layer is thin (<1)
        pen_mid = z[:, None].expand(shape)
        if edge:
            pen = pen_mid
        else:
            pen_od1 = (0.5 * (z + zp)[:, None]
                       - 0.5 * (zp - zn)[:, None] / torch.clamp(d, min=1e-30))
            pen = torch.where(d < 1.0, pen_mid, pen_od1)
        set_pen = active & (d > 0.0) & (cloud_dtau - d < 1.0)
        ztop = torch.where(set_pen, pen, ztop)
        # distinctive water layer or opaque column terminates (f:200-215)
        term = active & (((d > 1.0) & (at[:, lev][:, None] > 273.0))
                         | (tau > 5.0))
        crossed = torch.where(term, 99 * one_i, crossed)

    # unterminated thin clouds (f:222-243)
    ztop = torch.where(crossed == 1,
                       torch.where(tau > 0.5, ztop,
                                   torch.where(tau > 0.2, -1.0 + zero,
                                               zero)),
                       ztop)

    # neighbor pattern-matcher adjustment over the subcolumn axis
    # (f: "Modify MISR CTH for satellite spatial / pattern matcher")
    zl = ztop[:, :-2]
    zr = ztop[:, 2:]
    zc = ztop[:, 1:-1]
    adj = (zl > 0) & (zr > 0) & ((zl - zr).abs() < 500.0) & (zc < zr)
    ztop = torch.cat([ztop[:, :1], torch.where(adj, zr, zc), ztop[:, -1:]],
                     dim=1)

    box_cloudy = tau > _TAUCHK
    itau = torch.where(box_cloudy, digitize(tau, TAU_EDGES),
                       torch.zeros((), dtype=torch.int64, device=dev))

    detected = ztop != 0.0
    no_height = ztop == -1.0
    icth = torch.where(no_height, 0, _cth_bin(ztop))
    # histogram counts: "no height" bin needs only detection; height bins
    # also require an ISCCP-cloudy column (f:355-410)
    contrib = detected & (no_height | box_cloudy)
    fq = histogram(itau * N_MISR_CTH + icth, contrib, 7 * N_MISR_CTH) / ncol
    fq_misr = fq.reshape(npnt, 7, N_MISR_CTH).to(dtype)

    cldarea = detected.sum(dim=-1) / ncol
    mean_ztop = torch.where(
        cldarea > 0.0,
        torch.where(detected, ztop, zero).sum(dim=-1) / ncol
        / torch.clamp(cldarea, min=1e-12), zero)

    day = sunlit == 1
    return dict(
        fq_misr=torch.where(day[:, None, None], fq_misr, missing),
        dist_model_layertops=torch.where(day[:, None], dist_tops, missing),
        cldarea=torch.where(day, cldarea.to(dtype), missing),
        mean_ztop=torch.where(day, mean_ztop, missing),
        box_misr_ztop=ztop)
