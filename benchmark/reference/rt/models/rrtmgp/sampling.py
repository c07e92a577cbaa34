"""McICA cloud sampling (mo_cloud_sampling equivalents).

Port of geosradiation_gridcomp_tpu/models/rrtmgp/sampling.py: the
layer-correlation chains, lax.scans over levels there, are loops over
layers on [ncol, ngpt] planes; draw_samples is a gather through the
static g-point -> band index.
"""

import numpy as np
import torch

from ...tables import on_device


def sampled_mask_max_ran(urand, cloud_frac):
    """Maximum-random overlap cloud mask.

    Adjacent cloudy layers are maximally overlapped by REUSING the
    random deviate of the layer above; layers separated by clear sky
    are randomly overlapped (Raisanen et al. 2004 generator).

    urand: [ncol, ngpt, nlay]; cloud_frac: [ncol, nlay].
    Returns cld_mask bool [ncol, nlay, ngpt].
    """
    cf = cloud_frac[:, None, :].expand(urand.shape)
    r = urand[..., 0]
    masks = [r < cf[..., 0]]
    for k in range(1, urand.shape[-1]):
        cf_prev = cf[..., k - 1]
        r = torch.where(r < cf_prev, r,
                        cf_prev + (1.0 - cf_prev) * urand[..., k])
        masks.append(r < cf[..., k])
    return torch.stack(masks, dim=1)


def sampled_urand_gen_max_ran(alpha, urand, urand_aux):
    """Generalized maximum-random correlation of uniform deviates
    (Oreopoulos et al. 2012): where the auxiliary deviate falls below the
    layer-pair correlation alpha(k-1), the deviate from the layer above
    is reused.

    alpha: [ncol, nlay-1]; urand/urand_aux: [ncol, ngpt, nlay].
    Returns the correlated urand (same shape).
    """
    out = urand.clone()
    for k in range(1, urand.shape[-1]):
        out[..., k] = torch.where(urand_aux[..., k] < alpha[:, None, k - 1],
                                  out[..., k - 1], urand[..., k])
    return out


def gpoint_bands(band_lims_gpt):
    """0-based band of each g-point from [nbnd, 2] 1-based inclusive
    g-point limits, as int64 numpy."""
    lims = np.asarray(band_lims_gpt)
    gpt2band = np.zeros(int(lims[:, 1].max()), np.int64)
    for b, (g1, g2) in enumerate(lims):
        gpt2band[int(g1) - 1:int(g2)] = b
    return gpt2band


def draw_samples(cld_mask, props_bnd, band_lims_gpt):
    """Band -> g-point McICA sampling (mo_cloud_sampling draw_samples):
    each g-point of a cloudy cell receives its band's cloud optical
    properties; clear cells get zero.

    cld_mask: [ncol, nlay, ngpt] bool; props_bnd: dict of
    [ncol, nlay, nbnd] tensors; band_lims_gpt: [nbnd, 2] 1-based
    inclusive g-point limits per band (static).

    Returns dict of [ncol, nlay, ngpt] tensors.
    """
    idx = on_device(gpoint_bands(band_lims_gpt), cld_mask.device)
    return {k: torch.where(cld_mask, v[..., idx], v.new_zeros(()))
            for k, v in props_bnd.items()}
