"""The realistic multi-deck test scene, as torch tensors.

Same numpy draws, in the same order, as the reference's
`__graft_entry__._example_inputs`, so both frameworks see bit-identical
inputs from one seed.
"""

import numpy as np
import torch

from .driver.radiation import AtmosInputs


def example_inputs(ncol=32, nlev=72, seed=0, device="cuda"):
    """The scene as AtmosInputs on device (the card unless the caller
    passes device="cpu")."""
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
    c = lambda v: np.full((ncol, nlev), v, np.float32)
    s = lambda v: np.full((ncol,), v, np.float32)
    t = lambda x: torch.as_tensor(x, device=device)
    return AtmosInputs(
        ple=t(ple), t=t(ta), qv=t(wa), ql=t(ql), qi=t(qi), qr=t(z),
        qs=t(z), rl=t(c(10.0)), ri=t(c(30.0)), rr=t(c(100.0)),
        rs=t(c(80.0)), o3=t(oa), fcld=t(fcld),
        ch4=t(c(1.8e-6)), n2o=t(c(320e-9)),
        cfc11=t(c(230e-12)), cfc12=t(c(520e-12)),
        hcfc22=t(c(240e-12)), co2=t(c(410e-6)),
        ts=t(ts), tsinst=t(ts), t2m=t(ts + 0.5), emis=t(s(0.99)),
        albvr=t(s(0.1)), albvf=t(s(0.1)), albnr=t(s(0.2)),
        albnf=t(s(0.2)),
        lats=t(np.linspace(-1.2, 1.2, ncol).astype(np.float32)),
        lons=t(np.linspace(0.0, 6.0, ncol).astype(np.float32)))
