"""Refreshes back to back: the port's captured `radiation_refresh` called
by one caller, as a GCM's radiation component is called at its alarm,
each call synchronised before the next (the model reads its outputs).

Traffic (the workload file's "traffic"): `columns` of the benchmark's
scene at the configuration's levels; one refresh an hour through a day
of `hours` from `start_doy`, the first hour seed % hours, so every seed
runs the same hours in another order; with `daylight_packing` the SW
lit-column bound of GEOS's NumLit is fixed in set-up as the largest over
the day's hours (sw_partition_bounds, rounded up to `packing_bucket`),
so that every refresh of the window replays one captured graph. A unit
of the window is one refresh.
"""

import time

import torch

import program
import scene
from reference.compare import Reference, compare_states


class Loop:
    def __init__(self, cell, seed, spans, device="cuda"):
        from geosradiation_gridcomp_tpu_torch.driver.step import (
            radiation_refresh, sw_partition_bounds)
        w, c = cell.workload["traffic"], cell.config
        t0 = time.perf_counter()
        self.cell, self.spans, self.device = cell, spans, device
        self.ncol = w["columns"]
        self.arrays = scene.scene(self.ncol, c["nlev"], seed)
        self.inp = program.port_inputs(self.arrays, device)
        program.sync(device)
        t1 = time.perf_counter()
        self.cfg = program.port_config(c)
        self.ict, self.icb = program.superlayers(self.cfg, self.arrays)
        self.schedule = program.day_schedule(w["start_doy"], w["hours"],
                                             seed % w["hours"])
        self.nlit = self.ncld = None
        if w["daylight_packing"]:
            bounds = [sw_partition_bounds(self.inp.lons, self.inp.lats,
                                          self.inp.fcld, d, u, self.cfg,
                                          w["packing_bucket"])
                      for d, u in self.schedule]
            if all(b[0] is not None for b in bounds):
                self.nlit = max(b[0] for b in bounds)
            if all(b[1] is not None for b in bounds):
                self.ncld = max(b[1] for b in bounds)
        self._refresh = radiation_refresh
        t2 = time.perf_counter()
        self.samples = program.Reservoir(cell.workload["samples"], seed)
        # warm-up: the first call captures the graph, the second replays
        for doy, utc in self.schedule[:2]:
            self.call(doy, utc)
        program.sync(self.device)
        self.setup_phases = dict(scene=t1 - t0, bounds=t2 - t1,
                                 warm_up=time.perf_counter() - t2)

    def call(self, doy, utc):
        return self._refresh(self.inp, doy, utc, config=self.cfg,
                             ict=self.ict, icb=self.icb, sw_nlit=self.nlit,
                             sw_ncld=self.ncld)

    def run(self, seconds, stretch):
        """Refreshes until `seconds` have passed; the window ends with the
        last one's synchronise."""
        spans, n = self.spans, len(self.schedule)
        times, i = [], 0
        start = time.perf_counter()
        while True:
            stretch.at_unit(i)
            doy, utc = self.schedule[i % n]
            t0 = time.perf_counter()
            with spans("refresh"):
                out = self.call(doy, utc)
            with spans("sync"):
                program.sync(self.device)
            end = time.perf_counter()
            times.append(end - t0)
            self.samples.offer(i, (i, doy, utc, out))
            i += 1
            if end - start >= seconds and not stretch.pending:
                break
        stretch.at_unit(i)
        self.window = dict(units=i, seconds=end - start, times=times)
        return i

    def end_to_end(self):
        w = self.window
        return {"refresh_cols_per_s": self.ncol * w["units"] / w["seconds"]}

    def refresh_units(self, first, count):
        """The (doy, utc) of each refresh of units first .. first+count."""
        n = len(self.schedule)
        return [self.schedule[i % n] for i in range(first, first + count)]

    def release(self):
        """Drop the port's inputs; the sample of answers stays."""
        del self.inp

    def reference(self, control=False):
        """The reference (or its control) for this cell's scene."""
        return Reference(self.cell.config, self.arrays, self.device,
                         self.cell.workload["reference_block"], control)

    def answers(self, ref):
        """The port's sampled answers and the reference's to the same
        refreshes, in pairs."""
        w = self.cell.workload["traffic"]
        nlit = ref.packing(self.schedule, w["packing_bucket"]) \
            if w["daylight_packing"] else None
        return [(out, ref.refresh(doy, utc, nlit))
                for _, doy, utc, out in self.samples.items]

    @staticmethod
    def compare(got, want):
        return compare_states(got, want)
