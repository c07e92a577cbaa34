"""The model loop's radiation interval with GEOS's SATSIM child
(GEOS_SatsimGridComp.F90 SIM_DRIVER :2799, the COSP call :3722): at each
alarm the port's captured `radiation_refresh`, then the port's captured
`satsim.cosp_simulator` on the alarm's state (ISCCP, MISR, MODIS,
CALIPSO and CloudSat on the configuration's `satsim` subcolumns); at
every heartbeat the captured `radiation_update`. One caller, each call
synchronised before the next (the model reads its outputs).

Traffic, clock, skin temperature and packing are the heartbeat loop's
(drivers/heartbeat_loop.py, whose Loop this one extends). The COSP
inputs are satsim_scene.py's, built in set-up: every field but mcosz
once, mcosz and the threefry key once for each alarm of the day, all on
the device, so that the window copies nothing from the host. A unit of
the window is one radiation interval: the alarm's refresh and COSP call,
then each heartbeat's update up to the next alarm. The benchmark's
spans: `clock`, `refresh`, `satsim`, `update`, and a `sync` after each
call.
"""

import os
import time

import torch

import harness
import program
import satsim_scene
from reference.compare import worst
from reference.satsim import SatsimReference, compare_satsim

heartbeat_loop = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "heartbeat_loop.py"), "bench_driver_heartbeat_loop")
DAY_S = heartbeat_loop.DAY_S


class Loop(heartbeat_loop.Loop):
    def __init__(self, cell, seed, spans, device="cuda"):
        from geosradiation_gridcomp_tpu_torch.satsim import (
            SatsimConfig, SatsimInputs, cosp_simulator, prec_scops)
        super().__init__(cell, seed, spans, device)
        t0 = time.perf_counter()
        c = cell.config
        self.seed = seed
        self.satsim_cfg = SatsimConfig(**c["satsim"])
        self._cosp, self._prec_scops = cosp_simulator, prec_scops
        self._satsim_inputs = SatsimInputs
        self.base = {k: torch.as_tensor(v, device=device)
                     for k, v in satsim_scene.fields(self.arrays).items()}
        self.mcosz = [satsim_scene.mcosz(self.arrays, d, u, c["solar_dt"],
                                         device) for d, u in self.alarms]
        self.keys = [satsim_scene.key(seed, k, len(self.alarms), device)
                     for k in range(len(self.alarms))]
        # set-up: the first alarm's COSP call (captures its graph)
        self.cosp_out = self.cosp(0)
        program.sync(device)
        self.setup_phases["satsim_warm_up"] = time.perf_counter() - t0

    def cosp(self, k):
        """The port's COSP answer at alarm k of the day."""
        return self._cosp(self.keys[k], self._satsim_inputs(
            **self.base, mcosz=self.mcosz[k]), self.satsim_cfg)

    def run(self, seconds, stretch):
        """Radiation intervals until `seconds` have passed; the window ends
        with the last one's synchronise."""
        spans, clock, sync = self.spans, self.clock, program.sync
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
                    k = beat // self.per_alarm
                    with spans("refresh"):
                        self.states = self.refresh(*alarm)
                    with spans("sync"):
                        sync(self.device)
                    with spans("satsim"):
                        self.cosp_out = self.cosp(k)
                    with spans("sync"):
                        sync(self.device)
                    item = dict(alarm=alarm, k=k, states=self.states,
                                cosp=self.cosp_out, updates=[])
                with spans("update"):
                    out = self.update(beat)
                with spans("sync"):
                    sync(self.device)
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

    def release(self):
        super().release()
        del self.cosp_out, self.mcosz, self.keys

    def answers(self, ref):
        """Pairs of the port's and the reference's answers to the sampled
        intervals: the heartbeat loop's, then each alarm's COSP answer
        with prec_frac (the port's prec_scops on the port's frac_out)."""
        sat = SatsimReference(ref, self.arrays, self.cell.config, self.seed,
                              self.alarms)
        b = self.base
        pairs = []
        for (got, want), item in zip(super().answers(ref),
                                     self.samples.items):
            port = dict(item["cosp"], prec_frac=self._prec_scops(
                b["qr"] + b["qs"] + b["qg"], torch.zeros_like(b["qr"]),
                item["cosp"]["frac_out"]))
            pairs.append(((*got, port), (*want, sat.cosp(item["k"]))))
        return pairs

    def compare(self, got, want):
        return worst([super().compare(got[:2], want[:2]),
                      compare_satsim(got[2], want[2])])
