"""What the loops take from the port (`geosradiation_gridcomp_tpu_torch`):
its configuration from a configuration file, its inputs from the
benchmark's scene, and the per-refresh shapes and the sample of answers
that the benchmark keeps for itself. The port is imported inside the
functions, never when this module is imported.
"""

import random

import numpy as np

import scene


def sync(device):
    """Wait for the device (nothing to wait for on the CPU)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def port_config(config, overrides=None):
    """The port's RadiationConfig for a configuration file's dict."""
    from geosradiation_gridcomp_tpu_torch.config import (RadiationConfig,
                                                         Scheme)
    return RadiationConfig(sw_scheme=Scheme(config["sw_scheme"]),
                           lw_scheme=Scheme(config["lw_scheme"]),
                           condensate_inhomogeneity=config[
                               "condensate_inhomogeneity"],
                           run_dt=config["run_dt"],
                           solar_dt=config["solar_dt"], **(overrides or {}))


def port_inputs(arrays, device):
    from geosradiation_gridcomp_tpu_torch.driver.radiation import \
        AtmosInputs
    return scene.inputs(AtmosInputs, arrays, device)


def superlayers(config_obj, arrays):
    """(ict, icb) from the first column's mid-level pressures, as GEOS
    derives them from PREF."""
    ple0 = arrays["ple"][0].astype(np.float64)
    return config_obj.superlayer_indices(0.5 * (ple0[1:] + ple0[:-1]))


def day_schedule(start_doy, hours, first):
    """The (doy, utc hours) of a day's refreshes, one an hour, starting at
    hour `first`: every seed gets the same hours, in another order."""
    return [(start_doy + h / 24.0, float(h))
            for h in ((first + i) % hours for i in range(hours))]


def refresh_shapes(arrays, config, doy, utc):
    """The shapes of one refresh's work for the roofline counts: from the
    scene's cloud fraction and the columns lit in its interval, by the
    reference's astronomy."""
    import torch
    from reference.rt.driver.astronomy import mean_cos_zenith
    fcld = arrays["fcld"]
    ncol, nlay = fcld.shape
    cloudy = (fcld > 0.0).any(axis=1)
    # the layers from the top through the lowest cloudy one
    depth = np.where(cloudy, nlay - np.argmax((fcld > 0.0)[:, ::-1], axis=1),
                     0)
    _, lit = mean_cos_zenith(torch.as_tensor(arrays["lons"]),
                             torch.as_tensor(arrays["lats"]), doy, utc,
                             config["solar_dt"] / 3600.0)
    lit = lit.numpy() > 0.0
    return dict(ncol=ncol, nlay=nlay, ngpt_lw=config["ngpt_lw"],
                ngpt_sw=config["ngpt_sw"], nband_lw=config["nband_lw"],
                nband_sw=config["nband_sw"], cloudy_cols=int(cloudy.sum()),
                cloudy_depth_lw=int(depth.sum()), lit_cols=int(lit.sum()),
                lit_cloudy_cols=int((lit & cloudy).sum()),
                cloudy_depth_sw=int(depth[lit].sum()))


class Reservoir:
    """A sample of k answers drawn uniformly, with a generator seeded from
    the run's seed, from all that the window completes (Vitter's
    algorithm R): which answers are checked is not known while they are
    made."""

    def __init__(self, k, seed):
        self.k = k
        self.rng = random.Random(seed)
        self.items = []

    def offer(self, i, item):
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.items[j] = item
