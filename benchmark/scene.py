"""The benchmark's scene: the realistic multi-deck scene of the port's
`scene.example_inputs`, frozen here so that a later change to the port's
scene does not move the yardstick, with the columns spread evenly over
the globe.

The numpy draws are those of `example_inputs`, in the same order, from
`numpy.random.default_rng(seed)`: per-column surface pressure and skin
temperature, three cloud decks with per-column coverage. Only the
latitudes and longitudes differ: a Fibonacci lattice over the sphere in
place of one diagonal line, so that at every hour about half of the
columns are lit, as GEOS's solar load balancing gives every process its
share of lit columns. The lattice does not depend on the seed.
"""

import numpy as np

# the AtmosInputs fields, in the order of the NamedTuple of the port and
# of the reference
FIELDS = ("ple", "t", "qv", "ql", "qi", "qr", "qs", "rl", "ri", "rr", "rs",
          "o3", "fcld", "ch4", "n2o", "cfc11", "cfc12", "hcfc22", "co2",
          "ts", "tsinst", "t2m", "emis", "albvr", "albvf", "albnr", "albnf",
          "lats", "lons")


def globe(ncol):
    """Latitudes and longitudes [rad] of a Fibonacci lattice of ncol
    points: equal areas, no two on one meridian."""
    j = np.arange(ncol, dtype=np.float64) + 0.5
    lats = np.arcsin(1.0 - 2.0 * j / ncol)
    lons = np.mod(j * np.pi * (3.0 - np.sqrt(5.0)), 2.0 * np.pi)
    return lats.astype(np.float32), lons.astype(np.float32)


def scene(ncol, nlev, seed):
    """The scene as a dict of float32 numpy arrays, one per FIELDS entry."""
    rng = np.random.default_rng(seed)
    ptop = 1.0
    # per-column surface pressure: the McICA seeds derive from the
    # fractional Pa of the lowest layers, so identical columns would share
    # one stochastic realization
    psfc = 101325.0 * (1.0 + 0.02 * rng.standard_normal(ncol))
    a = np.linspace(0.0, 1.0, nlev + 1) ** 1.6
    ple = (ptop * (psfc[:, None] / ptop) ** a[None, :]).astype(np.float32)
    pmid = 0.5 * (ple[:, 1:] + ple[:, :-1])
    ts = (294.0 + 3.0 * rng.standard_normal(ncol)).astype(np.float32)
    ta = np.maximum(ts[:, None] * (pmid / ple[:, -1:]) ** 0.19, 216.65)
    ta = (ta + 55.0 * np.exp(-0.5 * ((np.log10(pmid) - 2.0) / 0.55) ** 2)
          ).astype(np.float32)
    wa = (0.016 * (pmid / pmid[:, -1:]) ** 3.2 + 3e-6).astype(np.float32)
    oa = (1e-5 * np.exp(-0.5 * ((np.log10(pmid) - 3.0) / 0.42) ** 2)
          + 2e-8).astype(np.float32)
    # cirrus, mid-level and boundary-layer decks with per-column coverage
    fcld = np.zeros((ncol, nlev), np.float32)
    sigma = pmid / ple[:, -1:]
    hi_deck = (sigma > 0.18) & (sigma < 0.32)
    mid_deck = (sigma > 0.42) & (sigma < 0.58)
    low_deck = (sigma > 0.78) & (sigma < 0.92)
    cover = rng.uniform(0.0, 1.0, (ncol, 1))
    fcld += np.where(hi_deck, rng.uniform(0.1, 0.6, (ncol, nlev))
                     * (cover > 0.3), 0.0)
    fcld += np.where(mid_deck, rng.uniform(0.1, 0.5, (ncol, nlev))
                     * (cover > 0.5), 0.0)
    fcld += np.where(low_deck, rng.uniform(0.2, 0.9, (ncol, nlev))
                     * (cover > 0.2), 0.0)
    fcld = np.clip(fcld, 0.0, 1.0).astype(np.float32)
    qi = np.where(fcld * hi_deck > 0, 8e-6, 0.0).astype(np.float32) \
        + np.where(fcld * mid_deck > 0, 2e-5, 0.0).astype(np.float32)
    ql = (np.where(fcld * mid_deck > 0, 3e-5, 0.0)
          + np.where(fcld * low_deck > 0, 1.2e-4, 0.0)).astype(np.float32)
    z = np.zeros((ncol, nlev), np.float32)

    def c(v):
        return np.full((ncol, nlev), v, np.float32)

    def s(v):
        return np.full((ncol,), v, np.float32)
    lats, lons = globe(ncol)
    return dict(
        ple=ple, t=ta, qv=wa, ql=ql, qi=qi, qr=z, qs=z, rl=c(10.0),
        ri=c(30.0), rr=c(100.0), rs=c(80.0), o3=oa, fcld=fcld,
        ch4=c(1.8e-6), n2o=c(320e-9), cfc11=c(230e-12), cfc12=c(520e-12),
        hcfc22=c(240e-12), co2=c(410e-6), ts=ts, tsinst=ts, t2m=ts + 0.5,
        emis=s(0.99), albvr=s(0.1), albvf=s(0.1), albnr=s(0.2),
        albnf=s(0.2), lats=lats, lons=lons)


def inputs(cls, arrays, device):
    """The scene as the AtmosInputs NamedTuple cls (the port's or the
    reference's) of tensors on device, each field a copy of its own."""
    import torch
    return cls(*(torch.as_tensor(arrays[f], device=device).clone()
                 for f in FIELDS))
