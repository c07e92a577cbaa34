"""The SATSIM cell's inputs to the COSP simulators, from the benchmark's
scene (scene.py), frozen here so that both the port and the reference
are given the same arrays and a later change to either does not move
them.

The scene has no heights, precipitation, graupel, land or sun, so they
are made from it, by the recipe of chip_smoke.py's satsim_inputs:
- edge heights by hypsometric integration of ple and t from the surface;
- 2e-5 kg/kg rain from the top of a column's low deck (sigma 0.78-0.92,
  cloudy) down to the surface, and 1e-5 snow from the top of its mid
  deck (0.42-0.58) down;
- no graupel, at 150 um (the radar integrates its plane all the same);
- the scene's radii in metres;
- land on the second half of the points;
- mcosz the mean cosine of the zenith over the alarm's radiation
  interval, by the reference's astronomy, one tensor per alarm.

The threefry key of alarm k of a run with seed s is jax.random.key's
pair for the 64-bit seed s * alarms + k: (its high word, its low word),
which is the port's threefry.key(s * alarms + k) wherever that is below
2**32.
"""

import numpy as np

from reference.rt.constants import AMD, GRAV, RGAS

MASK = 0xFFFFFFFF


def _below_deck(fcld, sigma, lo, hi, q):
    """q from the top of the column's cloudy deck lo < sigma < hi to the
    surface, zero elsewhere and in columns without the deck."""
    deck = (sigma > lo) & (sigma < hi) & (fcld > 0.0)
    top = np.argmax(deck, axis=1)
    lev = np.arange(fcld.shape[1])
    return np.where(deck.any(axis=1)[:, None] & (lev >= top[:, None]),
                    np.float32(q), np.float32(0.0)).astype(np.float32)


def fields(arrays):
    """Every SatsimInputs field but mcosz, as float32 numpy arrays."""
    ple = arrays["ple"].astype(np.float64)
    t = arrays["t"].astype(np.float64)
    dz = (RGAS * 1000.0 / AMD / GRAV) * t * np.log(ple[:, 1:] / ple[:, :-1])
    zle = np.concatenate([np.cumsum(dz[:, ::-1], axis=1)[:, ::-1],
                          np.zeros_like(dz[:, :1])], axis=1)
    sigma = 0.5 * (ple[:, 1:] + ple[:, :-1]) / ple[:, -1:]
    fcld = arrays["fcld"]
    ncol = fcld.shape[0]
    qr = _below_deck(fcld, sigma, 0.78, 0.92, 2e-5)

    def metres(r):
        return (arrays[r] * np.float32(1e-6)).astype(np.float32)
    return dict(
        ple=arrays["ple"], zle=zle.astype(np.float32), t=arrays["t"],
        qv=arrays["qv"], fcld=fcld, qi=arrays["qi"], ql=arrays["ql"],
        qr=qr, qs=_below_deck(fcld, sigma, 0.42, 0.58, 1e-5),
        qg=np.zeros_like(qr), ri=metres("ri"), rl=metres("rl"),
        rr=metres("rr"), rs=metres("rs"),
        rg=np.full_like(qr, np.float32(150e-6)), ts=arrays["ts"],
        frland=(np.arange(ncol) >= ncol // 2).astype(np.float32))


def mcosz(arrays, doy, utc, solar_dt, device):
    """[ncol] the mean cosine of the zenith over the radiation interval
    that starts at (doy, utc), on device."""
    import torch
    from reference.rt.driver.astronomy import mean_cos_zenith
    return mean_cos_zenith(torch.as_tensor(arrays["lons"], device=device),
                           torch.as_tensor(arrays["lats"], device=device),
                           doy, utc, solar_dt / 3600.0)[0]


def key(seed, k, alarms, device):
    """[2] int64: the threefry key of alarm k of a run with seed."""
    import torch
    n = seed * alarms + k
    return torch.tensor([(n >> 32) & MASK, n & MASK], dtype=torch.int64,
                        device=device)
