"""The model loop's radiation interval: the port's `RadiationClock` drives
its captured `radiation_refresh` at each alarm and its captured
`radiation_update` at every heartbeat, one caller, each call synchronised
before the next (the model reads its outputs).

Traffic (the workload file's "traffic"): `columns` of the benchmark's
scene; RadiationClock of the configuration's run_dt and solar_dt from
`start_doy`, 00 UTC plus
seed % 24 hours; after `alarms_per_day` alarms the clock steps back one
day, so the simulated day repeats and every seed runs the same alarms in
another order. At each heartbeat the update takes ts = tsinst +
ts_amplitude_k * sin(2 pi utc / 24 + lon), a diurnal cycle of the skin
temperature. The SW lit-column bound is fixed in set-up as the largest
over the day's alarms, so the window meets one static key. A unit of the
window is one radiation interval: an alarm's refresh and update, then
the updates of the heartbeats up to the next alarm.
"""

import math
import time

import torch

import program
import scene
from reference.compare import (Reference, compare_states, compare_update,
                               worst)

DAY_S = 86400.0


class Loop:
    def __init__(self, cell, seed, spans, device="cuda"):
        from geosradiation_gridcomp_tpu_torch.driver.clock import \
            RadiationClock
        from geosradiation_gridcomp_tpu_torch.driver.step import (
            radiation_refresh, radiation_update, sw_partition_bounds)
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
        self.per_alarm = int(round(c["solar_dt"] / c["run_dt"]))
        self.clock = RadiationClock(run_dt=c["run_dt"],
                                    solar_dt=c["solar_dt"],
                                    start_doy=w["start_doy"],
                                    start_utc_hours=float(seed % 24))
        self.alarms = [self._at(k * c["solar_dt"])
                       for k in range(w["alarms_per_day"])]
        bounds = [sw_partition_bounds(self.inp.lons, self.inp.lats,
                                      self.inp.fcld, d, u, self.cfg,
                                      w["packing_bucket"])
                  for d, u in self.alarms]
        self.nlit = None if any(b[0] is None for b in bounds) \
            else max(b[0] for b in bounds)
        self.ncld = None if any(b[1] is None for b in bounds) \
            else max(b[1] for b in bounds)
        # the skin temperature of each heartbeat of the day
        beats = int(round(DAY_S / c["run_dt"]))
        self.ts = ts_table(self.inp.tsinst, self.inp.lons, beats,
                           w["ts_amplitude_k"], self.clock)
        self._refresh, self._update = radiation_refresh, radiation_update
        t2 = time.perf_counter()
        self.samples = program.Reservoir(cell.workload["samples"], seed)
        # set-up: the first interval (captures both graphs), so that the
        # window starts on an alarm
        self.states = self.refresh(*self._at(0.0))
        self.update(0)
        for _ in range(self.per_alarm - 1):
            self.clock.tick()
            self.update(self._beat())
        program.sync(self.device)
        self.setup_phases = dict(scene=t1 - t0, bounds=t2 - t1,
                                 warm_up=time.perf_counter() - t2)

    def _at(self, t):
        """(doy, utc) of the clock at t seconds from its start."""
        saved = self.clock.time_s
        self.clock.time_s = t
        out = (self.clock.doy, self.clock.utc_hours)
        self.clock.time_s = saved
        return out

    def _beat(self):
        return int(round(self.clock.time_s / self.clock.run_dt))

    def refresh(self, doy, utc):
        return self._refresh(self.inp, doy, utc, config=self.cfg,
                             ict=self.ict, icb=self.icb, sw_nlit=self.nlit,
                             sw_ncld=self.ncld)

    def update(self, beat):
        return self._update(*self.states, self.ts[beat], self.inp.lons,
                            self.inp.lats, self.inp.ple, self.clock.doy,
                            self.clock.utc_hours, config=self.cfg)

    def run(self, seconds, stretch):
        """Radiation intervals until `seconds` have passed; the window ends
        with the last one's synchronise."""
        spans, clock = self.spans, self.clock
        i = 0
        start = time.perf_counter()
        while True:
            stretch.at_unit(i)
            item = None
            for _ in range(self.per_alarm):
                with spans("clock"):
                    if clock.time_s + clock.run_dt >= DAY_S:
                        clock.time_s -= DAY_S
                    acts = clock.tick()
                    beat = self._beat()
                if "refresh" in acts:
                    alarm = (clock.doy, clock.utc_hours)
                    with spans("refresh"):
                        self.states = self.refresh(*alarm)
                    with spans("sync"):
                        program.sync(self.device)
                    item = dict(alarm=alarm, states=self.states, updates=[])
                with spans("update"):
                    out = self.update(beat)
                with spans("sync"):
                    program.sync(self.device)
                item["updates"].append((beat, clock.doy, clock.utc_hours,
                                        out))
            end = time.perf_counter()
            self.samples.offer(i, item)
            i += 1
            if end - start >= seconds and not stretch.pending:
                break
        stretch.at_unit(i)
        self.window = dict(units=i, seconds=end - start)
        return i

    def end_to_end(self):
        w = self.window
        return {"cycle_ms": 1e3 * w["seconds"] / w["units"]}

    def refresh_units(self, first, count):
        """The (doy, utc) of the alarm of units first .. first+count."""
        n = len(self.alarms)
        # the window's unit i is the alarm one past set-up's, i + 1
        return [self.alarms[(i + 1) % n] for i in range(first, first + count)]

    def release(self):
        del self.inp, self.states

    def reference(self, control=False):
        return Reference(self.cell.config, self.arrays, self.device,
                         self.cell.workload["reference_block"], control)

    def answers(self, ref):
        """Pairs of the port's and the reference's answers to the sampled
        intervals: the refresh's states and every update's exports, the
        reference's updates run from its own states."""
        bucket = self.cell.workload["traffic"]["packing_bucket"]
        nlit = ref.packing(self.alarms, bucket)
        pairs = []
        for item in self.samples.items:
            states = ref.refresh(*item["alarm"], nlit)
            pairs.append(((item["states"], [u[3] for u in item["updates"]]),
                          (states, [ref.update(*states, self.ts[b], doy, utc)
                                    for b, doy, utc, _ in item["updates"]])))
        return pairs

    def compare(self, got, want):
        ple = torch.as_tensor(self.arrays["ple"], device=self.device)
        return worst([compare_states(got[0], want[0])]
                     + [compare_update(g, w, ple)
                        for g, w in zip(got[1], want[1])])


def ts_table(tsinst, lons, beats, amplitude, clock):
    """[beats, ncol]: the skin temperature at each heartbeat of the day,
    tsinst + amplitude * sin(2 pi utc / 24 + lon)."""
    rows = []
    for b in range(beats):
        utc = (clock.start_utc_hours + b * clock.run_dt / 3600.0) % 24.0
        rows.append(tsinst + amplitude * torch.sin(
            lons + 2.0 * math.pi * utc / 24.0))
    return torch.stack(rows)
