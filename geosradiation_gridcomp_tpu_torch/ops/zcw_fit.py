"""The TPU kernels' polynomial fit of the zcw condensate scaling.

Port of geosradiation_gridcomp_tpu/ops/mcica_pallas.py:_class_columns,
_zcw_fit, _asin and _zcw_eval. The TPU kernels evaluate zcw(cdf, class)
as one arcsin-warped degree-14 polynomial per sigma class, with the head
(cdf < 1/999) and tail (the last five bins) exact; the port's kernels K1
and K2 read the exact (3, 1000) class table instead. The fit is kept for
the verification suite (tools/verify.py, its same-draws A/B gate of fit
against table) and the profiling check of its accuracy: plain torch, not
a kernel.
"""

from functools import lru_cache

import numpy as np
import torch

from .mcica import ZCW_N1, class_columns

# fitted region in cdf space: exact linear head below _LO, exact
# piecewise-linear tail above _HI, one warped polynomial in between
_LO = 1.0 / 999.0
_HI = 994.0 / 999.0
_DEG = 14
# Abramowitz & Stegun 4.4.46: asin(x) = pi/2 - sqrt(1 - x) * P7(x)
_ASIN_C = (-0.0012624911, 0.0066700901, -0.0170881256, 0.0308918810,
           -0.0501743046, 0.0889789874, -0.2145988016, 1.5707963050)

__all__ = ("class_columns", "zcw_fit", "zcw_eval")


@lru_cache(maxsize=None)
def zcw_fit(inhm):
    """Fit constants for the zcw evaluation (numpy, as the reference).

    Returns dict: head [3, 2] (value = head[c, 0] + f1 * head[c, 1] for
    cdf < 1/999); poly [3, deg+1] power-basis coefficients, high to low,
    in the normalized arcsin-warped coordinate t = a * asin(2v - 1) + b;
    warp (a, b); tail_int / tail_slp [3, 5], the linear pieces for the
    bins ind1 in {995..999}.
    """
    cols = class_columns(inhm)

    def f_exact(x, col):
        rind1 = x * (ZCW_N1 - 1) + 1.0
        i = np.clip(np.floor(rind1).astype(int), 1, ZCW_N1 - 1)
        return col[i - 1] + (rind1 - i) * (col[i] - col[i - 1])

    x = np.linspace(_LO, _HI, 200000)
    u = np.arcsin(2.0 * x - 1.0)
    ua, ub = u.min(), u.max()
    t = (u - ua) / (ub - ua) * 2.0 - 1.0
    poly = np.zeros((3, _DEG + 1), np.float64)
    for c in range(3):
        cf = np.polynomial.chebyshev.chebfit(t, f_exact(x, cols[c]), _DEG)
        poly[c] = np.polynomial.chebyshev.cheb2poly(cf)[::-1]
    wa = 2.0 / (ub - ua)
    wb = -2.0 * ua / (ub - ua) - 1.0
    head = np.stack([cols[:, 0], cols[:, 1] - cols[:, 0]], axis=1)
    return dict(head=head.astype(np.float32),
                poly=poly.astype(np.float32),
                warp=(float(wa), float(wb)),
                tail_int=cols[:, 994:999].astype(np.float32),
                tail_slp=(cols[:, 995:1000]
                          - cols[:, 994:999]).astype(np.float32))


def _asin(z):
    """asin on [-1, 1] by Abramowitz & Stegun 4.4.46 (|err| < 2e-8), as
    the TPU kernel evaluates it."""
    x = torch.abs(z)
    p = torch.full_like(z, _ASIN_C[0])
    for c in _ASIN_C[1:]:
        p = p * x + c
    a = 1.5707963267948966 - torch.sqrt(torch.clamp(1.0 - x, min=0.0)) * p
    return torch.where(z < 0.0, -a, a)


def zcw_eval(v, cls, fit):
    """zcw(v, class) by the fit: v [...] float32 cdf values in [0, 1);
    cls (is0, is1) bool tensors broadcasting against v (class 0, class 1,
    else class 2); fit from zcw_fit. Returns a tensor shaped like v."""
    is0, is1 = cls
    f32 = v.dtype

    def csel(c3):
        """Class-selected constant."""
        return torch.where(is0, float(c3[0]),
                           torch.where(is1, float(c3[1]),
                                       float(c3[2]))).to(f32)

    rind1 = v * (ZCW_N1 - 1) + 1.0
    wa, wb = fit["warp"]
    t = wa * _asin(torch.clamp(2.0 * v - 1.0, -1.0, 1.0)) + wb
    poly = fit["poly"]
    accs = []
    for c in range(3):
        acc = torch.full_like(v, float(poly[c, 0]))
        for k in range(1, _DEG + 1):
            acc = acc * t + float(poly[c, k])
        accs.append(acc)
    acc = torch.where(is0, accs[0], torch.where(is1, accs[1], accs[2]))

    # exact head: cdf < 1/999
    vhead = csel(fit["head"][:, 0]) + (v * (ZCW_N1 - 1)) \
        * csel(fit["head"][:, 1])
    # exact tail: ind1 in {995..999}
    ind1 = torch.clamp(torch.floor(rind1).to(torch.int32), 1, ZCW_N1 - 1)
    f1 = rind1 - ind1.to(f32)
    p = torch.clamp(ind1 - 995, 0, 4)
    ti, ts = fit["tail_int"], fit["tail_slp"]
    inter = csel(ti[:, 0])
    slp = csel(ts[:, 0])
    for q in range(1, 5):
        inter = torch.where(p == q, csel(ti[:, q]), inter)
        slp = torch.where(p == q, csel(ts[:, q]), slp)
    vtail = inter + f1 * slp
    return torch.where(v < float(np.float32(_LO)), vhead,
                       torch.where(ind1 >= 995, vtail, acc))
