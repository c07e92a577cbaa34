"""The radar simulator's arguments, shared by the port's radar tests on
the CPU, under the CUDA emulator and on the card."""

import numpy as np


def radar_arrays(npnt, ncol, nlev):
    """quickbeam_simulator's arguments: every one of the 9 hydrometeor
    classes present in a random ~15 % of the subcolumns, with radii given
    (and 0 = derive / class default) at random; gridbox profiles from the
    surface to 16 km, temperatures past both Mie tables' ends. float32
    numpy: hgt, p, tc, rh [npnt, nlev], hm, re [9, npnt, ncol, nlev]."""
    rng = np.random.default_rng(6)
    z = np.linspace(16.0, 0.3, nlev)
    hgt = np.tile(z, (npnt, 1)).astype(np.float32)
    p = (1000.0 * np.exp(-z / 7.5))[None, :].repeat(npnt, 0)
    tc = (15.0 - 6.5 * z)[None, :] + rng.uniform(-3, 3, (npnt, 1))
    rh = rng.uniform(20.0, 100.0, (npnt, nlev))
    shape = (9, npnt, ncol, nlev)
    hm = np.where(rng.random(shape) < 0.15, rng.uniform(0.0, 1.0, shape),
                  0.0)
    re_scale = np.array([12., 40., 500., 800., 12., 40., 500., 800.,
                         1000.])[:, None, None, None]
    re = np.where(rng.random(shape) < 0.7,
                  re_scale * rng.uniform(0.5, 1.5, shape), 0.0)
    return tuple(np.asarray(a, np.float32) for a in (hgt, p, tc, rh, hm, re))
