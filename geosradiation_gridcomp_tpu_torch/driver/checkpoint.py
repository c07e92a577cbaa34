"""Checkpoint save/restore for the radiation internal state.

Port of geosradiation_gridcomp_tpu/driver/checkpoint.py, in the same file
layout, so a checkpoint written by either package loads in the other: one
.npz with a flat "<tree>/<field>" namespace for the (SolarState,
IrradState[, RatsState]) tensors, plus a JSON header (uint8 bytes under
"__header__") for the host clock and any extra metadata, written
atomically (temp file + rename).

The reference checkpoints its MAPL Internal states (normalized Solar
fluxes, GEOS_SolarGridComp.F90:694-701; Irrad fluxes + dF/dTs + Ts,
GEOS_IrradGridComp.F90:1370-1387). A restart reproduces the
uninterrupted run exactly when the checkpoint is written at a heartbeat
boundary, the only place this API is called: the AtmosInputs are
instantaneous, so every heartbeat boundary is seamless
(GEOS_SolarGridComp.F90:117-119).
"""

import json
import os

import numpy as np
import torch

from .clock import RadiationClock
from .state import IrradState, RatsState, SolarState

_CLASSES = {"solar": SolarState, "irrad": IrradState, "rats": RatsState}


def save_checkpoint(path, *, solar=None, irrad=None, rats=None, clock=None,
                    extra=None):
    """Write a radiation checkpoint .npz (atomically via temp+rename)."""
    arrays = {}
    header = {"format": 1}
    for name, tree in (("solar", solar), ("irrad", irrad), ("rats", rats)):
        if tree is None:
            continue
        header[name] = type(tree).__name__
        for field, value in tree._asdict().items():
            arrays[f"{name}/{field}"] = value.detach().cpu().numpy()
    if clock is not None:
        header["clock"] = clock.state_dict()
    if extra:
        header["extra"] = extra
    arrays["__header__"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path, device="cuda"):
    """Read a checkpoint. Returns a dict with any of the solar/irrad/rats/
    clock/extra keys present in the file; the states' tensors on device
    (the card unless the caller passes device="cpu")."""
    out = {}
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"].tobytes()).decode())
        for name, cls in _CLASSES.items():
            prefix = name + "/"
            fields = {k[len(prefix):]: z[k] for k in z.files
                      if k.startswith(prefix)}
            if fields:
                out[name] = cls(**{f: torch.as_tensor(fields[f],
                                                      device=device)
                                   for f in cls._fields})
    if "clock" in header:
        out["clock"] = RadiationClock.from_state_dict(header["clock"])
    if "extra" in header:
        out["extra"] = header["extra"]
    return out
