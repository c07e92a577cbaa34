"""Random-number generator hierarchy (mo_rng equivalents).

Port of geosradiation_gridcomp_tpu/models/rrtmgp/rng.py. ThreefryRNG is the
counter-based device generator on ops/threefry.py, bit-identical to the
reference's jax.random stream for the same seeds; MT19937RNG is the
host-side Mersenne Twister (numpy), its draws returned as tensors.
Both put their draws on `device`, the card unless the caller says
otherwise.
"""

import numpy as np
import torch

from ...ops import threefry


class ThreefryRNG:
    """Counter-based device RNG (the MKL-VSL Philox analog)."""

    def __init__(self, seeds, device="cuda"):
        """seeds: int or int sequence (mixed into one key), e.g. the
        per-column global index like the reference's Philox seeding."""
        seeds = np.atleast_1d(np.asarray(seeds, np.uint32))
        key = threefry.key(int(seeds[0]), device=device)
        for s in seeds[1:]:
            key = threefry.fold_in(key, torch.tensor(
                int(s), dtype=torch.int64, device=key.device))
        self._key = key

    def get_random_vec(self, num_or_shape):
        """Uniform (0,1) float32 draws; advances the stream."""
        shape = (num_or_shape,) if isinstance(num_or_shape, int) \
            else tuple(num_or_shape)
        self._key, sub = threefry.split(self._key, 2)
        return threefry.uniform(sub, shape)

    def get_random_vec_mask(self, mask):
        """Draws only for True elements of mask (others zero), matching
        mo_rng's get_random_vec_mask contract."""
        mask = torch.as_tensor(mask, device=self._key.device)
        r = self.get_random_vec(mask.shape)
        return torch.where(mask, r, torch.zeros_like(r))

    # mo_rng naming
    init_rng = __init__

    def end_rng(self):
        self._key = None


class MT19937RNG:
    """Host-side Mersenne-Twister (mo_rng_mt19937 equivalent); float64
    draws, returned on `device`."""

    def __init__(self, seeds, device="cuda"):
        seeds = np.atleast_1d(np.asarray(seeds, np.uint32))
        self._rs = np.random.Generator(np.random.MT19937(seeds))
        self._device = torch.device(device)

    def get_random_vec(self, num_or_shape):
        shape = (num_or_shape,) if isinstance(num_or_shape, int) \
            else tuple(num_or_shape)
        return torch.as_tensor(self._rs.random(shape, np.float64),
                               device=self._device)

    def get_random_vec_mask(self, mask):
        mask = (mask.cpu().numpy() if isinstance(mask, torch.Tensor)
                else np.asarray(mask))
        out = np.zeros(mask.shape)
        out[mask] = self._rs.random(int(mask.sum()))
        return torch.as_tensor(out, device=self._device)

    def end_rng(self):
        self._rs = None
