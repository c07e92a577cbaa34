"""RRTMG-SW all-sky McICA driver (the reference's rrtmg_sw), PyTorch.

Port of geosradiation_gridcomp_tpu/models/rrtmg/sw.py through its non-TPU
branch: optional day/cloud column sort with the static nlit slice ->
McICA subcolumns and delta-scaled cloud optics (K2) -> setcoef -> NRLSSI2
solar source -> taumol (K5) -> spcvmc two-stream and adding (K6) -> night
zeros and scatter-back. Each kernel wrapper runs its plain twin for CPU
tensors and its CUDA kernel for CUDA tensors.

All inputs TOA-first. Water paths are IN-CLOUD values in g/m^2.
"""

import numpy as np
import torch
from torch import nn

from ...ops.mcica import _sigma_class, overlap_params, zcw_class_columns
from ...ops.mcica_cuda import mcica_optics_sw, mcica_optics_sw_plain
from .cldprmc_sw import (CLOUD_TABLE_KEYS, ICE_TABLE_KEYS, CloudPackSW,
                         pack_cloud_tables_sw, sw_cloud_tables)
from .nrlssi2 import solar_source_weights
from .setcoef_sw import setcoef_sw
from .spcvmc import spcvmc_sw
from .spcvmc_cuda import device_weights, spcvmc_fast
from .tables_sw import NGPTSW, sw_tables
from .taumol_lw import TaumolTables
from .taumol_sw import (solar_source_tables, sfluxzen_only, taumol_sw,
                        taumol_tables)
from .taumol_sw_cuda import taumol_sw_fast

# SW seed order: reversed against LW (rrtmg_sw_rad.F90:1402)
SEED_ORDER_SW = (3, 2, 1, 0)
# bands 10-13 (1-based) take the UV/vis albedos, the others the NIR ones
_UVBAND = (np.arange(1, 15) >= 10) & (np.arange(1, 15) <= 13)


class RRTMGSW(nn.Module):
    """RRTMG-SW with its coefficient tables as buffers.

    Buffers: the packed k-distribution (`taumol_pack`, `taumol_offsets`,
    indexed by `taumol_index`), the reference profile (`preflog`,
    `tref`), the cloud optics tables, the same packed per iceflag as K2
    reads them (`cloud_pack1`..`3`) and the McICA xcw class columns.
    The solar-source tables, which depend on the NRLSSI2 weights of the
    configuration, are built on first use and kept per weight set.
    """

    def __init__(self, taumol, reference, cloud, zcw):
        super().__init__()
        self.taumol_index = taumol.index
        self.register_buffer("taumol_pack", taumol.pack)
        self.register_buffer("taumol_offsets", taumol.offsets)
        for k, v in {**reference, **cloud, **zcw}.items():
            self.register_buffer(k, v)
        for f in ICE_TABLE_KEYS:
            self.register_buffer(f"cloud_pack{f}",
                                 pack_cloud_tables_sw(cloud, f).pack)
        self._sources = {}
        if self.preflog.device.type == "cuda":
            device_weights(self.preflog.device)

    @classmethod
    def from_reference_tables(cls, device="cuda"):
        """Build the buffers on device from the reference's numpy tables
        (the port's copies of its loaders)."""
        t = sw_tables()
        reference = {k: torch.as_tensor(t[k], device=device)
                     for k in ("preflog", "tref")}
        zcw = {"zcw_beta": torch.as_tensor(zcw_class_columns(1),
                                           device=device),
               "zcw_gamma": torch.as_tensor(zcw_class_columns(2),
                                            device=device)}
        return cls(taumol_tables(device), reference, sw_cloud_tables(device),
                   zcw)

    @property
    def taumol_tables(self):
        return TaumolTables(self.taumol_pack, self.taumol_offsets,
                            self.taumol_index)

    @property
    def reference_tables(self):
        return {"preflog": self.preflog, "tref": self.tref}

    @property
    def cloud_tables(self):
        return {k: getattr(self, k) for k in CLOUD_TABLE_KEYS}

    def cloud_pack(self, iceflag):
        """The CloudPackSW K2 reads for iceflag (1, 2 or 3), built once."""
        if iceflag not in ICE_TABLE_KEYS:
            raise ValueError(f"iceflag {iceflag} does not exist for RRTMG-SW")
        return CloudPackSW(getattr(self, f"cloud_pack{iceflag}"), iceflag,
                           getattr(self, ICE_TABLE_KEYS[iceflag][0]).shape[0],
                           self.extliq1.shape[0])

    def zcw_cols(self, inhm):
        return self.zcw_beta if inhm == 1 else self.zcw_gamma

    def solar_sources(self, svw):
        """Per-band solar-source tables for the NRLSSI2 weights svw, as
        float32 tensors on the module's device."""
        key = tuple(np.asarray(w).tobytes() for w in svw)
        if key not in self._sources:
            self._sources[key] = {
                b: torch.as_tensor(v, device=self.preflog.device)
                for b, v in solar_source_tables(svw).items()}
        return self._sources[key]

    def forward(self, *args, **kwargs):
        return rrtmg_sw(self, *args, **kwargs)


def rrtmg_sw(sw, ple, play, tlay, coszen, albdir_uv, albdif_uv,
             albdir_nir, albdif_nir, h2ovmr, o3vmr, co2vmr, ch4vmr, o2vmr,
             cldf, ciwp, clwp, rei, rel, zm, alat, doy,
             taua=None, ssaa=None, asya=None, adjes=1.0, *, scon=1361.0,
             isolvar=-1, solcycfrac=None, indsolvar=None, bndscl=None,
             iceflag=3, liqflag=1, cloud_mh=1, cloud_lm=2, inhm=1,
             nlit=None, ncld=None, plain=False):
    """RRTMG SW fluxes with McICA clouds.

    sw: an RRTMGSW holding the tables. Args (TOA-first):
      ple [ncol, nlay+1] Pa; play [ncol, nlay] hPa; tlay [K];
      coszen [ncol]; albedos [ncol] (UV/vis and NIR, direct/diffuse);
      gas vmrs [ncol, nlay]; cldf, ciwp/clwp (in-cloud, g/m^2), rei/rel
      (micron), zm (m) [ncol, nlay]; alat [ncol] rad; doy scalar;
      taua/ssaa/asya: optional [ncol, nlay, 14] aerosol optics;
      scon: solar constant (0 = scheme-internal); adjes: Earth-Sun factor;
      isolvar/solcycfrac/indsolvar/bndscl: NRLSSI2 solar variability;
      cloud_mh/cloud_lm: 1-based super-layer boundary layer indices.
      nlit: bound on the number of lit (coszen > 0) columns, or None to
        compute every column. When given, columns are sorted day-cloudy /
        day-clear / night and only the first nlit run the SW pipeline;
        the caller guarantees nlit >= the lit count (lit columns beyond
        it are zeroed, as in the reference).
      ncld: bound on the number of cloudy columns among those (the
        cloudy-first sort puts them first): the all-sky solve runs on
        those only. Same caller contract as nlit.
    plain=True runs the plain PyTorch twins of K2, K5 and K6 whatever the
    device: the reference the kernels are held to on the card.

    Returns dict of fluxes (W/m^2): the level profiles [ncol, nlay+1]
    (bbfu, bbfd, bbcu, bbcd, direct, UV and NIR variants), the surface
    quantities [ncol] and band fluxes [ncol, 14] of spcvmc_sw, and
    clear_counts [ncol, 4] (skipped columns read fully clear).
    """
    ncol_full = cldf.shape[0]
    if nlit is not None and nlit >= ncol_full:
        nlit = None
    sort_clear = nlit is not None or ncld is not None
    if sort_clear:
        clearcol = (~(cldf > 0.0).any(dim=1)).to(torch.int32)
        key = clearcol if nlit is None \
            else 2 * (coszen <= 0.0).to(torch.int32) + clearcol
        perm = torch.argsort(key, stable=True)
        inv = torch.argsort(perm)
        keep = perm if nlit is None else perm[:nlit]
        (ple, play, tlay, coszen, albdir_uv, albdif_uv, albdir_nir,
         albdif_nir, h2ovmr, o3vmr, co2vmr, ch4vmr, o2vmr, cldf, ciwp,
         clwp, rei, rel, zm, alat, taua, ssaa, asya) = (
            None if x is None else x[keep]
            for x in (ple, play, tlay, coszen, albdir_uv, albdif_uv,
                      albdir_nir, albdif_nir, h2ovmr, o3vmr, co2vmr,
                      ch4vmr, o2vmr, cldf, ciwp, clwp, rei, rel, zm, alat,
                      taua, ssaa, asya))
    else:
        ncld = None

    if liqflag != 1:
        raise NotImplementedError("only liqflag=1 (Hu & Stamnes) exists")
    alpha, rcorr = overlap_params(zm, alat, doy)
    mcica = mcica_optics_sw_plain if plain else mcica_optics_sw
    taucmc, ssacmc, asmcmc, cldymc, counts = mcica(
        play.contiguous(), alpha, rcorr, cldf, ciwp, clwp, _sigma_class(cldf),
        rei.contiguous(), rel.contiguous(), sw.cloud_pack(iceflag),
        sw.zcw_cols(inhm), cloud_mh=cloud_mh, cloud_lm=cloud_lm,
        seed_order=SEED_ORDER_SW, inhm=inhm, cwp_tiny=1.0e-20)

    coefs = setcoef_sw(play, tlay, ple * 0.01, h2ovmr, o3vmr, co2vmr,
                       ch4vmr, o2vmr, sw.reference_tables)
    svw = solar_source_weights(isolvar, scon, solcycfrac, indsolvar, bndscl)
    taug, taur = (taumol_sw if plain else taumol_sw_fast)(
        coefs, sw.taumol_tables)
    sfluxzen = sfluxzen_only(coefs, sw.solar_sources(svw))

    uv = torch.as_tensor(_UVBAND, device=cldf.device)
    albdir = torch.where(uv, albdir_uv[:, None], albdir_nir[:, None])
    albdif = torch.where(uv, albdif_uv[:, None], albdif_nir[:, None])

    out = (spcvmc_sw if plain else spcvmc_fast)(
        coefs, taug, taur, sfluxzen, coszen, albdir, albdif, cldymc, taucmc,
        ssacmc, asmcmc, taua=taua, ssaa=ssaa, asya=asya, adjflux=adjes,
        ncld=ncld)
    # zero out fluxes for night columns
    day = (coszen > 0.0).to(taug.dtype)
    out = {k: v * day.reshape((-1,) + (1,) * (v.ndim - 1))
           for k, v in out.items()}
    out["clear_counts"] = counts
    if nlit is not None:
        # scatter back: exact zeros for skipped (night) columns, which
        # read fully clear
        pad = ncol_full - nlit

        def restore(v, fill):
            return torch.cat([v, v.new_full((pad,) + v.shape[1:], fill)])[inv]
        out = {k: restore(v, NGPTSW if k == "clear_counts" else 0)
               for k, v in out.items()}
    elif sort_clear:
        out = {k: v[inv] for k, v in out.items()}
    return out
