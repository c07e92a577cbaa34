"""McICA stochastic cloud subcolumn generator (plain PyTorch).

Port of geosradiation_gridcomp_tpu/ops/mcica.py, the CPU oracle:
exponential overlap in cloud presence and condensate, decorrelation lengths
from the Oreopoulos et al. (2012) fit, condensate-inhomogeneity scaling from
the xcw tables, and per-column seeds from the fractional Pa of the lowest
layers. The random fields are the oracle's threefry stream bit for bit
(ops/threefry.py), so masks and clear counts match it exactly.

Vertical ordering: TOA at index 0.
"""

import numpy as np
import torch

from ..tables import load
from . import threefry

# Oreopoulos et al. (2012) decorrelation-length parameters
AAM1, AAM2, AAM30, AAM4 = 1.4315, 2.1219, 7.0, -25.584      # cloud presence
RAM1, RAM2, RAM30, RAM4 = 0.72192, 0.78996, 8.5, 40.404     # condensate

_R2D = 180.0 / 3.14159265358979323846
_MAXIMO = 2147483646.0
# 1000-point cdf axis of the xcw tables
ZCW_N1 = 1000


def correlation_length(am1, am2, am30, am4, doy, alat):
    """Decorrelation length [m] (cloud_subcol_gen.F90:634-660)."""
    doy = torch.as_tensor(doy, dtype=torch.float32, device=alat.device)
    am3 = torch.where(doy > 181,
                      -4.0 * am30 / 365.0 * (doy - 272),
                      4.0 * am30 / 365.0 * (doy - 91))
    d = alat * _R2D - am3
    return (am1 + am2 * torch.exp(-(d * d) / am4 ** 2)) * 1.0e3


def overlap_params(zmid, alat, doy):
    """Per-layer exponential-overlap correlations (alpha for cloud
    presence, rcorr for condensate), [ncol, nlay] with layer 0 = 0."""
    adl = correlation_length(AAM1, AAM2, AAM30, AAM4, doy, alat)
    rdl = correlation_length(RAM1, RAM2, RAM30, RAM4, doy, alat)
    dz = torch.abs(zmid[:, 1:] - zmid[:, :-1])
    zero = torch.zeros_like(zmid[:, :1])
    alpha = torch.cat([zero, torch.exp(-dz / adl[:, None])], dim=1)
    rcorr = torch.cat([zero, torch.exp(-dz / rdl[:, None])], dim=1)
    return alpha, rcorr


def state_seed_ints(play_hpa, seed_order=(0, 1, 2, 3)):
    """Four deterministic uint32 seeds (as int64) from near-surface layer
    pressures, in float32 exactly as the oracle forms them.

    play_hpa: [..., nlay] TOA first. Returns [..., 4].
    """
    pseed = play_hpa[..., [-1, -2, -3, -4]] * 100.0   # lowest four, in Pa
    pseed = pseed[..., list(seed_order)]
    return ((pseed - torch.floor(pseed)) * _MAXIMO + 1.0).to(torch.int64)


def state_seed_key(play_hpa, seed_order=(0, 1, 2, 3)):
    """Per-column threefry key: key(0) folded with the four state seeds.
    Returns [..., 2] int64 word pairs."""
    ints = state_seed_ints(play_hpa, seed_order)
    k = threefry.key(0, device=play_hpa.device).expand(
        ints.shape[:-1] + (2,))
    for i in range(4):
        k = threefry.fold_in(k, ints[..., i])
    return k


def subcolumn_keys(play_hpa, seed_order=(0, 1, 2, 3)):
    """The four per-column subkeys the generator draws its fields from
    (jax.random.split(state_seed_key, 4)): [ncol, 4, 2] int64."""
    return threefry.split(state_seed_key(play_hpa, seed_order), 4)


def _sigma_class(cldfrac):
    """Static sigma_qcw class: 0 -> 0.5 (cf>0.99), 1 -> 0.71 (cf>0.9),
    2 -> 1.0."""
    return ((cldfrac <= 0.99).to(torch.int32)
            + (cldfrac <= 0.9).to(torch.int32))


def class_columns(inhm):
    """(3, 1000) float64 xcw columns for the 3 sigma_qcw classes
    {0.5, 0.71, 1.0}, blended in sigma as the oracle blends them
    (geosradiation_gridcomp_tpu/ops/mcica.py:148-157)."""
    tab = np.asarray(load("chou_xcw_inhomogeneity")[
        "xcw_beta" if inhm == 1 else "xcw_gamma"], np.float64)
    n2 = tab.shape[1]
    cols = []
    for s in (0.5, 0.71, 1.0):
        r2 = 40.0 * s - 3.0
        j = int(min(max(int(r2), 1), n2 - 1))
        f2 = r2 - j
        cols.append((1.0 - f2) * tab[:, j - 1] + f2 * tab[:, j])
    return np.stack(cols, 0)


def zcw_class_columns(inhm):
    """The class columns cast to float32: the oracle's class table."""
    return class_columns(inhm).astype(np.float32)


def zcw_lookup_class(cdf, sigcls, zcw_cols):
    """Condensate scaling factor for the 3 static sigma_qcw classes: linear
    interpolation along the cdf axis of the class column.

    cdf: [...] uniforms; sigcls: [...] int in {0, 1, 2}; zcw_cols (3, 1000).
    """
    rind1 = cdf * (ZCW_N1 - 1) + 1.0
    ind1 = torch.clamp(torch.floor(rind1).to(torch.int64), 1, ZCW_N1 - 1)
    f1 = rind1 - ind1.to(cdf.dtype)
    flat = zcw_cols.reshape(-1)
    base = sigcls.to(torch.int64) * ZCW_N1 + ind1
    lo = flat[base - 1]
    hi = flat[base]
    return lo * (1.0 - f1) + hi * f1


def _correlate(cdf, keepmask):
    """Overlap chain as a forward fill: layer l inherits the value of the
    nearest layer at or above it with keepmask=True (layer 0 always keeps
    its own). cdf, keepmask: [..., nlay]."""
    out = cdf.clone()
    for l in range(1, cdf.shape[-1]):
        out[..., l] = torch.where(keepmask[..., l], cdf[..., l],
                                  out[..., l - 1])
    return out


def _draws(keys, alpha, rcorr, cldfrac, nsubcol, condensate):
    """The generator's raw draws, [ncol, nsubcol, nlay]: the presence test
    of the forward-filled presence cdf (bool) and, when condensate, the
    forward-filled condensate cdf (else None)."""
    shape = (nsubcol, cldfrac.shape[1])
    cdf1 = threefry.uniform(keys[:, 0], shape)
    cdf2 = threefry.uniform(keys[:, 1], shape)
    cdf1 = _correlate(cdf1, cdf2 >= alpha[:, None, :])
    cloudy = cdf1 >= 1.0 - cldfrac[:, None, :]
    if not condensate:
        return cloudy, None
    cdf2b = threefry.uniform(keys[:, 2], shape)
    cdf3 = threefry.uniform(keys[:, 3], shape)
    return cloudy, _correlate(cdf3, cdf2b >= rcorr[:, None, :])


def subcolumns_raw(keys, alpha, rcorr, cldfrac, nsubcol):
    """The raw draws behind subcolumns (plain twin of kernel K7): the
    presence mask before the water-path test and the forward-filled
    condensate cdf the zcw scaling is evaluated at, from the same threefry
    uniforms as subcolumns.

    keys [ncol, 4, 2] from subcolumn_keys; alpha, rcorr, cldfrac
    [ncol, nlay]. Returns (cloudy, v3), each [ncol, nlay, nsubcol] float32
    (cloudy 0/1), the layout of the reference's mcica_subcols_raw.
    """
    cloudy, cdf3 = _draws(keys, alpha, rcorr, cldfrac, nsubcol, True)
    return (cloudy.to(cdf3.dtype).transpose(1, 2).contiguous(),
            cdf3.transpose(1, 2).contiguous())


def subcolumns(keys, alpha, rcorr, cldfrac, ciwp, clwp, sigcls, zcw_cols,
               cwp_tiny, nsubcol, inhm=1):
    """Subcolumn cloud mask and water paths from precomputed per-column
    keys and overlap parameters (the body of the oracle's per-column
    generator).

    keys: [ncol, 4, 2] from subcolumn_keys; alpha, rcorr, cldfrac, ciwp,
    clwp: [ncol, nlay]; sigcls [ncol, nlay] int; zcw_cols (3, 1000).
    Returns cldy [ncol, nsubcol, nlay] bool and the two water paths.
    """
    cloudy, cdf3 = _draws(keys, alpha, rcorr, cldfrac, nsubcol, inhm != 0)
    if inhm != 0:
        zcw = zcw_lookup_class(cdf3, sigcls[:, None, :].expand_as(cdf3),
                               zcw_cols)
    else:
        zcw = torch.ones(cloudy.shape, dtype=ciwp.dtype, device=ciwp.device)
    zero = torch.zeros((), dtype=zcw.dtype, device=zcw.device)
    ciwp_s = torch.where(cloudy, ciwp[:, None, :] * zcw, zero)
    clwp_s = torch.where(cloudy, clwp[:, None, :] * zcw, zero)
    ciwp_s = torch.where(ciwp_s <= cwp_tiny, zero, ciwp_s)
    clwp_s = torch.where(clwp_s <= cwp_tiny, zero, clwp_s)
    cloudy = cloudy & ((ciwp_s > 0.0) | (clwp_s > 0.0))
    return cloudy, ciwp_s, clwp_s


def generate_stochastic_clouds(zmid, alat, doy, play, cldfrac, ciwp, clwp,
                               cwp_tiny, *, nsubcol, inhm=1,
                               seed_order=(0, 1, 2, 3), zcw_cols=None,
                               col_block=512):
    """McICA subcolumns for a batch of gridcolumns (the oracle's
    generate_stochastic_clouds).

    zmid [ncol, nlay] layer mid heights (m); alat [ncol] (rad); doy scalar;
    play [ncol, nlay] (hPa); cldfrac, ciwp, clwp [ncol, nlay].
    zcw_cols: the (3, 1000) class columns for inhm (built from the
    reference tables when None). Columns run in blocks of col_block to
    bound the [block, nsubcol, nlay] temporaries.

    Returns cldy [ncol, nsubcol, nlay] bool, ciwp_stoch, clwp_stoch.
    """
    alpha, rcorr = overlap_params(zmid, alat, doy)
    sigcls = _sigma_class(cldfrac)
    keys = subcolumn_keys(play, seed_order)
    if zcw_cols is None and inhm != 0:
        zcw_cols = torch.as_tensor(zcw_class_columns(inhm),
                                   device=cldfrac.device)
    parts = [subcolumns(keys[s], alpha[s], rcorr[s], cldfrac[s], ciwp[s],
                        clwp[s], sigcls[s], zcw_cols, cwp_tiny, nsubcol,
                        inhm)
             for s in column_blocks(cldfrac.shape[0], col_block)]
    return tuple(torch.cat(x, dim=0) for x in zip(*parts))


def column_blocks(n, size):
    """Slices cutting n columns into blocks of at most size."""
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]


def clear_counts_three_band(cldy, cloud_mh, cloud_lm):
    """Counts of fully clear subcolumns: total, high, mid, low.

    cldy: [ncol, nsubcol, nlay] TOA-first; cloud_mh/cloud_lm 1-based layer
    indices (GEOS LCLDMH/LCLDLM). Returns [ncol, 4] int32.
    """
    any_tot = cldy.any(dim=-1)
    any_high = cldy[..., :cloud_mh - 1].any(dim=-1)
    any_mid = cldy[..., cloud_mh - 1:cloud_lm - 1].any(dim=-1)
    any_low = cldy[..., cloud_lm - 1:].any(dim=-1)
    return torch.stack([(~a).sum(dim=-1).to(torch.int32)
                        for a in (any_tot, any_high, any_mid, any_low)],
                       dim=-1)
