"""SCOPS: Subgrid Cloud Overlap Profile Sampler (+ precip assignment).

Port of geosradiation_gridcomp_tpu/satsim/scops.py (scops.f:40+ and
llnl/prec_scops.f): the level loop carrying the overlap threshold is a
Python loop over levels with all (point, subcolumn) lanes vectorized. The
draws are the reference's counter-based threefry stream, bit for bit
(`ops/threefry.py`): uniform(key, (nlev, npoints, nsubcol)).

Subcolumn codes match the reference: frac_out 0 = clear, 1 = stratiform
cloud, 2 = convective cloud; prec_frac 0 = clear, 1 = large-scale precip,
2 = convective precip, 3 = both. All arrays TOA-first.
"""

import torch

from ..ops import threefry


def scops(key, cc, conv, nsubcol, overlap=3):
    """Sample binary cloud subcolumns from layer cloud fractions.

    Args:
      key: [2] int64 threefry key pair (threefry.key(seed)).
      cc:   [npoints, nlev] TOTAL cloud fraction per layer (TOA-first).
      conv: [npoints, nlev] convective cloud fraction per layer.
      nsubcol: number of subcolumns.
      overlap: 1 max, 2 random, 3 max-random (scops.f:49-52).

    Returns frac_out [npoints, nsubcol, nlev] int8 (0/1/2).
    """
    npoints, nlev = cc.shape
    dtype = cc.dtype
    # ordered pointer to position in gridbox (scops.f:104-108)
    boxpos = ((torch.arange(nsubcol, dtype=dtype, device=cc.device) + 0.5)
              / nsubcol)[None, :]
    boxpos_full = boxpos.expand(npoints, nsubcol)

    ran = threefry.uniform(key.to(cc.device), (nlev, npoints, nsubcol))

    # initial threshold (scops.f:168-186): only consulted by the
    # max-random maxosc test at the first level, where tca_prev=0 makes
    # it moot; kept for fidelity
    if overlap == 1:
        thresh = boxpos_full
    else:
        c0 = conv[:, 0][:, None]
        thresh = c0 + (1.0 - c0) * ran[0]
    tca_prev = torch.zeros(npoints, dtype=dtype, device=cc.device)
    one = torch.ones((), dtype=torch.int8, device=cc.device)
    zero = torch.zeros((), dtype=torch.int8, device=cc.device)
    two = one + one
    frac_seq = []
    for lev in range(nlev):
        cc_l, ran_l = cc[:, lev], ran[lev]
        ccx = cc_l[:, None]
        cvx = conv[:, lev][:, None]
        # max-overlapped convective part (scops.f:205-211)
        maxocc = boxpos <= cvx
        if overlap == 3:
            mintca = torch.minimum(tca_prev, cc_l)[:, None]
            tmin = torch.maximum(cvx, mintca)
            maxosc = (thresh < mintca) & (thresh > cvx)
        else:
            tmin = cvx
            maxosc = torch.full_like(maxocc, overlap == 1)
        # threshold reset (scops.f:249-272)
        thresh = torch.where(
            maxocc, boxpos_full,
            torch.where(maxosc, thresh, tmin + (1.0 - tmin) * ran_l))
        # fill: 1 where tca exceeds threshold, 2 in the convective part
        frac = torch.where(ccx > thresh, one, zero)
        frac_seq.append(torch.where(thresh <= cvx, two, frac))
        tca_prev = cc_l
    return torch.stack(frac_seq, dim=-1)     # [npoints, nsubcol, nlev]


def prec_scops(ls_p_rate, cv_p_rate, frac_out):
    """Assign precipitation occurrence to subcolumns (llnl/prec_scops.f).

    Fallback cascade per level and precip type: (1) subcolumns cloudy at
    this level or precipitating just above; (2) cloudy at the level below;
    (3) cloudy anywhere in the column; (4) all subcolumns (LS) / the first
    5% of subcolumns (convective).

    Args: ls/cv_p_rate [npoints, nlev] precip rates; frac_out
    [npoints, nsubcol, nlev] from scops. Returns prec_frac int8 (0/1/2/3).
    """
    npoints, nsubcol, nlev = frac_out.shape
    dev = frac_out.device
    cv_col = max(int(0.05 * nsubcol), 1)
    first_cv = (torch.arange(nsubcol, device=dev) < cv_col)[None, :] \
        .expand(npoints, nsubcol)

    cld_ls = frac_out == 1               # [np, nsub, nlev]
    cld_cv = frac_out == 2
    anyls_col = cld_ls.any(dim=-1)       # [np, nsub] cloudy anywhere
    anycv_col = cld_cv.any(dim=-1)
    all_cols = torch.ones((npoints, nsubcol), dtype=torch.bool, device=dev)
    none = torch.zeros_like(all_cols)

    def pick(now, below, anywhere, everyone):
        """First non-empty candidate set per (point, level-step)."""
        f1 = now.any(dim=-1, keepdim=True)
        f2 = below.any(dim=-1, keepdim=True)
        f3 = anywhere.any(dim=-1, keepdim=True)
        return torch.where(f1, now,
                           torch.where(f2, below,
                                       torch.where(f3, anywhere, everyone)))

    prev = torch.zeros((npoints, nsubcol), dtype=torch.int8, device=dev)
    pf_seq = []
    for lev in range(nlev):
        # level-below occupancy (possibility THREE); empty at the bottom
        bel_ls = cld_ls[..., lev + 1] if lev + 1 < nlev else none
        bel_cv = cld_cv[..., lev + 1] if lev + 1 < nlev else none
        from_above_ls = (prev == 1) | (prev == 3)
        from_above_cv = (prev == 2) | (prev == 3)
        ls = pick(cld_ls[..., lev] | from_above_ls, bel_ls, anyls_col,
                  all_cols)
        cv = pick(cld_cv[..., lev] | from_above_cv, bel_cv, anycv_col,
                  first_cv)
        ls = ls & (ls_p_rate[:, lev] > 0.0)[:, None]
        cv = cv & (cv_p_rate[:, lev] > 0.0)[:, None]
        prev = (ls.to(torch.int8) + 2 * cv.to(torch.int8))
        pf_seq.append(prev)
    return torch.stack(pf_seq, dim=-1)
