"""RRTMG-LW all-sky McICA driver (the reference's rrtmg_lw), PyTorch.

Port of geosradiation_gridcomp_tpu/models/rrtmg/lw.py through its non-TPU
branch: the cloud table rows (K9) -> overlap parameters -> McICA
subcolumns from the state seeds, cloud optics and clear counts (K1) ->
setcoef with its Planck rows (K9) -> taumol (K3) -> rtrnmc (K4).
Each kernel function launches its CUDA kernel where
kernels.twins.use_kernel and runs its plain twin otherwise.

All inputs TOA-first. Water paths are IN-CLOUD values in g/m^2.
"""

import torch
from torch import nn

from ...constants import AMD, GRAV, RGAS
from ...driver.compiled import captured, with_kernels
from ...kernels.twins import twins
from ...ops.mcica import _sigma_class, overlap_params, zcw_class_columns
from ...ops.mcica_cuda import mcica_optics_lw
from .cldprmc_lw import CLOUD_TABLE_KEYS, band_abs_coeffs_lw, lw_cloud_tables
from .rtrnmc_cuda import rtrnmc_fast
from .setcoef_lw import setcoef_lw
from .tables_lw import lw_tables
from .taumol_lw import TaumolTables, pack_taumol_tables, taumol_offsets
from .taumol_lw_cuda import taumol_lw_fast

PLANCK_KEYS = ("preflog", "tref", "totplnk", "totplnkderiv")


def level_temperatures(play, tlay, plev, tsfc):
    """Interpolate layer temperatures to levels (TOA-first): interior levels
    linear in p between adjacent layers, the TOA level copies the top
    layer, the surface level is tsfc."""
    wt = (plev[..., 1:-1] - play[..., :-1]) \
        / (play[..., 1:] - play[..., :-1])
    interior = tlay[..., :-1] + wt * (tlay[..., 1:] - tlay[..., :-1])
    return torch.cat([tlay[..., :1], interior, tsfc[..., None]], dim=-1)


def mid_heights(play, tlay, psfc):
    """Layer-midpoint heights relative to the bottom layer via the
    hypsometric equation (only height differences matter)."""
    rd = RGAS / (AMD * 1e-3)
    lnp = torch.log(play)
    dlnp = torch.diff(lnp, dim=-1)
    tmid = 0.5 * (tlay[..., 1:] + tlay[..., :-1])
    seg = rd * tmid / GRAV * dlnp
    z_rel = torch.flip(torch.cumsum(torch.flip(seg, (-1,)), dim=-1), (-1,))
    return torch.cat([z_rel, torch.zeros_like(tlay[..., :1])], dim=-1)


class RRTMGLW(nn.Module):
    """RRTMG-LW with its coefficient tables as buffers.

    Buffers: the packed k-distribution (`taumol_pack`, with the kernel's
    `taumol_offsets`, both indexed by `taumol_index`), the Planck and
    reference-profile tables, the cloud optics tables and the McICA xcw
    class columns for the beta and gamma condensate PDFs.
    """

    def __init__(self, taumol_pack, taumol_index, planck, cloud, zcw):
        super().__init__()
        self.taumol_index = taumol_index
        self.register_buffer("taumol_pack", taumol_pack)
        self.register_buffer("taumol_offsets", torch.as_tensor(
            taumol_offsets(taumol_index), device=taumol_pack.device))
        for k, v in planck.items():
            self.register_buffer(k, v)
        for k, v in cloud.items():
            self.register_buffer(k, v)
        for k, v in zcw.items():
            self.register_buffer(k, v)

    @classmethod
    def from_reference_tables(cls, device="cuda"):
        """Build the buffers on device from the reference's numpy tables
        (the port's copies of its loaders)."""
        return cls(*reference_buffers(device))

    @property
    def taumol_tables(self):
        return TaumolTables(self.taumol_pack, self.taumol_offsets,
                            self.taumol_index)

    @property
    def planck_tables(self):
        return {k: getattr(self, k) for k in PLANCK_KEYS}

    @property
    def cloud_tables(self):
        return {k: getattr(self, k) for k in CLOUD_TABLE_KEYS}

    def zcw_cols(self, inhm):
        return self.zcw_beta if inhm == 1 else self.zcw_gamma

    def forward(self, ple, play, tlay, tlev, tsfc, emis,
                h2ovmr, o3vmr, co2vmr, ch4vmr, n2ovmr, o2vmr, covmr,
                cfc11vmr, cfc12vmr, cfc22vmr, ccl4vmr,
                cldf, ciwp, clwp, rei, rel, zm, alat, doy,
                taua=None, *, iceflag=3, liqflag=1, dudts=True,
                cloud_mh=1, cloud_lm=2, inhm=1, plain=False):
        return rrtmg_lw(self, ple, play, tlay, tlev, tsfc, emis,
                        h2ovmr, o3vmr, co2vmr, ch4vmr, n2ovmr, o2vmr,
                        covmr, cfc11vmr, cfc12vmr, cfc22vmr, ccl4vmr,
                        cldf, ciwp, clwp, rei, rel, zm, alat, doy, taua,
                        iceflag=iceflag, liqflag=liqflag, dudts=dudts,
                        cloud_mh=cloud_mh, cloud_lm=cloud_lm, inhm=inhm,
                        plain=plain)


def lw_planck_tables(device="cuda"):
    t = lw_tables()
    return {k: torch.as_tensor(t[k], device=device) for k in PLANCK_KEYS}


def reference_buffers(device="cuda"):
    """(taumol_pack, taumol_index, planck, cloud, zcw) from the reference's
    numpy tables: lw_tables()/lw_gather_tables() for the k-distribution,
    rrtmg_lw_cld for cloud optics, the Planck tables, and the (3, 1000)
    xcw class columns."""
    pack, index = pack_taumol_tables()
    zcw = {"zcw_beta": torch.as_tensor(zcw_class_columns(1), device=device),
           "zcw_gamma": torch.as_tensor(zcw_class_columns(2), device=device)}
    return (torch.as_tensor(pack, device=device), index,
            lw_planck_tables(device), lw_cloud_tables(device), zcw)


def rrtmg_lw_eager(lw, ple, play, tlay, tlev, tsfc, emis,
                   h2ovmr, o3vmr, co2vmr, ch4vmr, n2ovmr, o2vmr, covmr,
                   cfc11vmr, cfc12vmr, cfc22vmr, ccl4vmr,
                   cldf, ciwp, clwp, rei, rel, zm, alat, doy,
                   taua=None, *, iceflag=3, liqflag=1, dudts=True,
                   cloud_mh=1, cloud_lm=2, inhm=1, plain=False):
    """RRTMG LW all-sky fluxes with McICA clouds, run op by op.

    lw: an RRTMGLW holding the tables. Args (all TOA-first):
      ple [ncol, nlay+1] level pressure (Pa); play [ncol, nlay] (hPa);
      tlay [K]; tlev [ncol, nlay+1]; tsfc [ncol]; emis [ncol, 16];
      gas vmrs [ncol, nlay]; cldf, ciwp/clwp (in-cloud, g/m^2), rei/rel
      (micron) [ncol, nlay]; zm [ncol, nlay] mid heights (m); alat [rad];
      doy scalar; taua optional [ncol, nlay, 16];
      cloud_mh/cloud_lm: 1-based super-layer boundary layer indices.
    plain=True runs the plain PyTorch twins of K1, K3, K4 and K9 whatever
    the device (the body under kernels.twins.twins): the reference the
    kernels are held to on the card.

    Returns dict: uflx, dflx, uflxc, dflxc [ncol, nlay+1] (W/m^2,
    positive), duflx_dts, duflxc_dts, olrb, dolrb_dts [ncol, 16],
    clear_counts [ncol, 4].
    """
    with twins(plain):
        plev = ple * 0.01
        alpha, rcorr = overlap_params(zm, alat, doy)
        absi, absl = band_abs_coeffs_lw(rei, rel, lw.cloud_tables,
                                        iceflag=iceflag, liqflag=liqflag)
        taucmc, cloudy, counts = mcica_optics_lw(
            play.contiguous(), alpha, rcorr, cldf, ciwp, clwp,
            _sigma_class(cldf), absi.contiguous(), absl.contiguous(),
            lw.zcw_cols(inhm), cloud_mh=cloud_mh, cloud_lm=cloud_lm,
            inhm=inhm, cwp_tiny=1.0e-20)

        coefs = setcoef_lw(play, tlay, plev, tlev, tsfc, emis,
                           h2ovmr, o3vmr, co2vmr, ch4vmr, n2ovmr, o2vmr,
                           covmr, cfc11vmr, cfc12vmr, cfc22vmr, ccl4vmr,
                           lw.planck_tables, dudts=dudts)
        taug, pfracs = taumol_lw_fast(coefs, lw.taumol_tables, taua)
        out = rtrnmc_fast(emis.contiguous(), taug, pfracs, cloudy, taucmc,
                          coefs.planklay, coefs.planklev, coefs.plankbnd,
                          coefs.dplankbnd_dts, coefs.pwvcm, dudts=dudts)
        out["clear_counts"] = counts
        return out



rrtmg_lw = captured(
    rrtmg_lw_eager,
    static_argnames=("lw", "iceflag", "liqflag", "dudts", "cloud_mh",
                     "cloud_lm", "inhm", "plain"),
    route=with_kernels)
rrtmg_lw.__doc__ = """RRTMG LW all-sky fluxes with McICA clouds
(rrtmg_lw_eager's arguments and results), as a CUDA graph captured once
per static key on a card: the reference's static argnames, the table
module lw (by identity) and plain; doy and the tensors are traced. CPU
tensors and plain=True run the body eagerly."""
