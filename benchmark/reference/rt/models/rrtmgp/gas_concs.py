"""Gas concentrations container (mo_gas_concentrations equivalent).

Port of geosradiation_gridcomp_tpu/models/rrtmgp/gas_concs.py: a thin
validated dict of volume mixing ratios by gas name; scalars broadcast to
the column batch at use time.
"""

import torch

KNOWN_GASES = ("h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2",
               "cfc11", "cfc12", "hcfc22", "ccl4")


class GasConcs:
    """Volume mixing ratios by gas name (lowercase)."""

    def __init__(self, names=KNOWN_GASES):
        for n in names:
            if n.lower() not in KNOWN_GASES:
                raise ValueError(f"unknown gas {n!r}")
        self._names = tuple(n.lower() for n in names)
        self._vmr = {}

    @property
    def names(self):
        return self._names

    def set_vmr(self, gas: str, vmr):
        gas = gas.lower()
        if gas not in self._names:
            raise KeyError(f"gas {gas!r} not initialized")
        self._vmr[gas] = vmr
        return self

    def get_vmr(self, gas: str, like=None, default=0.0):
        """vmr in `like`'s dtype, a scalar broadcast to `like`'s shape,
        when like is given. A Python scalar is filled on like's device
        (torch.full_like), so no host copy synchronises the stream."""
        v = self._vmr.get(gas.lower(), default)
        if like is None:
            return v
        if not isinstance(v, torch.Tensor):
            return torch.full_like(like, v)
        v = v.to(like.dtype)
        return v.expand(like.shape) if v.ndim == 0 else v
