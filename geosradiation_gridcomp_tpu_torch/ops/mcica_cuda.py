"""Fused McICA + cloud optics: kernels K1 (LW) and K2 (SW), the raw draws
of kernel K7, and their plain twins.

K1 and K2 replace the TPU kernels geosradiation_gridcomp_tpu/ops/
mcica_pallas.py:mcica_optics_lw_fused and mcica_optics_sw_fused. Each
computes what the CPU oracle computes (generate_stochastic_clouds +
clear_counts_three_band + cldprmc_lw or cldprmc_sw): per column the four
threefry subkeys from its layer pressures and the seed order
(ops.mcica.subcolumn_keys, derived in the kernel's prologue), per
(column, g-point, layer) the four threefry uniforms, the two overlap
forward fills, the zcw condensate scaling from the exact class table,
then the band->g cloud optics, and the four clear subcolumn counts. K2
also evaluates the per-band SW optics itself, from the particle sizes and
the packed tables of its iceflag (cldprmc_sw.band_optics_coeffs_sw). K7
replaces mcica_pallas.py:mcica_subcols_raw, the verification suite's raw
draws, and takes the subkeys as an input. The CUDA sources are
csrc/mcica_lw.cu, csrc/mcica_sw.cu and csrc/mcica_raw.cu; all three
include the generator of csrc/mcica_gen.cuh.
"""

import torch

from ..kernels import build
from ..kernels.twins import use_kernel
from ..models.rrtmg.cldprmc_lw import cldprmc_from_band_coeffs
from ..models.rrtmg.cldprmc_sw import (ICE_TABLE_KEYS, LIQ_TABLE_KEYS,
                                       band_optics_coeffs_sw,
                                       cldprmc_from_band_coeffs_sw,
                                       unpack_cloud_tables_sw)
from .mcica import (clear_counts_three_band, column_blocks, subcolumn_keys,
                    subcolumns, subcolumns_raw)

NGPTLW = 140
NGPTSW = 112
SEED_ORDER_LW = (0, 1, 2, 3)


def seed_order_bits(seed_order):
    """The seed order as the kernels take it: entry j in bits 2j, 2j+1."""
    order = tuple(int(s) for s in seed_order)
    if len(order) != 4 or any(not 0 <= s < 4 for s in order):
        raise ValueError(f"seed_order must be 4 indices in 0..3, got "
                         f"{seed_order}")
    return sum(s << (2 * j) for j, s in enumerate(order))


def mcica_optics_lw_plain(play, alpha, rcorr, cldf, ciwp, clwp, sigcls,
                          absice, absliq, zcw_cols, *, cloud_mh, cloud_lm,
                          inhm=1, cwp_tiny=1.0e-20, seed_order=SEED_ORDER_LW,
                          col_block=1024):
    """Plain PyTorch twin of K1.

    play [ncol, nlay] f32 layer pressures (hPa, TOA first), whose lowest
    four layers seed each column's subkeys in seed_order
    (ops.mcica.subcolumn_keys); alpha, rcorr, cldf, ciwp, clwp [ncol, nlay]
    f32; sigcls [ncol, nlay] int; absice, absliq [ncol, nlay, 16] f32;
    zcw_cols (3, 1000) f32. Returns taucmc [ncol, nlay, 140], cloudy
    [ncol, nlay] bool, counts [ncol, 4] int32.
    """
    taus, clds, cnts = [], [], []
    for s in column_blocks(cldf.shape[0], col_block):
        cldy, ciwp_s, clwp_s = subcolumns(
            subcolumn_keys(play[s], seed_order), alpha[s], rcorr[s], cldf[s],
            ciwp[s], clwp[s], sigcls[s], zcw_cols, cwp_tiny, NGPTLW, inhm)
        cnts.append(clear_counts_three_band(cldy, cloud_mh, cloud_lm))
        tau_gl, cloudy = cldprmc_from_band_coeffs(cldy, ciwp_s, clwp_s,
                                                  absice[s], absliq[s])
        taus.append(tau_gl.transpose(-1, -2).contiguous())
        clds.append(cloudy)
    return torch.cat(taus), torch.cat(clds), torch.cat(cnts)


def _keys_u32(keys):
    """int64 words in [0, 2**32) -> the same bits as int32."""
    return torch.where(keys >= 2 ** 31, keys - 2 ** 32, keys).to(
        torch.int32).contiguous()


def _launch(lib, name, fields, sigcls, extra, outs, ints, cwp_tiny, cldf):
    """Launch K1 or K2 (entry point `name`) from lib: the per-cell fields
    (play, alpha, rcorr, cldf, ciwp, clwp), sigcls, the scheme's optics
    inputs and zcw (extra), the outputs, then the ints and cwp_tiny."""
    args = (*fields, sigcls.to(torch.int32).contiguous(), *extra, *outs)
    fn = build.entry(lib, name, len(args), len(ints), 1)
    rc = fn(*(t.data_ptr() for t in args), *ints, cwp_tiny,
            build.stream_of(cldf))
    build.check(rc, name)
    return outs


def _require(name, fields, ints, floats, zcw_cols):
    """The wrappers' contract: one CUDA device, contiguous, float32, the
    per-cell fields [ncol, nlay] with nlay >= 4 (the seeds' layers), and
    the (3, 1000) class table."""
    build.require_cuda(name, *fields, *ints, *floats, zcw_cols)
    if any(t.dtype != torch.float32 for t in (*fields, *floats, zcw_cols)):
        raise TypeError(f"{name}: float inputs must be float32")
    shape = fields[0].shape
    if len(shape) != 2 or shape[1] < 4 or any(
            t.shape != shape for t in (*fields, *ints)):
        raise ValueError(f"{name}: per-cell fields must all be [ncol, nlay]"
                         f" with nlay >= 4")
    if zcw_cols.shape != (3, 1000):
        raise ValueError(f"{name}: zcw_cols must be (3, 1000)")


def launch(lib, play, alpha, rcorr, cldf, ciwp, clwp, sigcls, absice,
           absliq, zcw_cols, cloud_mh, cloud_lm, inhm, cwp_tiny,
           seed_order=SEED_ORDER_LW):
    """Allocate the outputs and launch K1 from lib; returns them."""
    ncol, nlay = cldf.shape
    dev = cldf.device
    outs = (torch.empty((ncol, nlay, NGPTLW), dtype=torch.float32,
                        device=dev),
            torch.empty((ncol, nlay), dtype=torch.uint8, device=dev),
            torch.empty((ncol, 4), dtype=torch.int32, device=dev))
    taucmc, cloudy, counts = _launch(
        lib, "mcica_optics_lw", (play, alpha, rcorr, cldf, ciwp, clwp),
        sigcls, (absice, absliq, zcw_cols), outs,
        (ncol, nlay, cloud_mh, cloud_lm, inhm, seed_order_bits(seed_order)),
        cwp_tiny, cldf)
    return taucmc, cloudy.bool(), counts


def mcica_optics_lw(play, alpha, rcorr, cldf, ciwp, clwp, sigcls, absice,
                    absliq, zcw_cols, *, cloud_mh, cloud_lm, inhm=1,
                    cwp_tiny=1.0e-20, seed_order=SEED_ORDER_LW):
    """K1: McICA subcolumns + LW cloud optics + clear counts, the
    subkeys derived in the kernel from play.

    The plain twin unless kernels.twins.use_kernel; then the kernel.
    Same arguments and results as mcica_optics_lw_plain.
    """
    ins = (play, alpha, rcorr, cldf, ciwp, clwp, sigcls, absice, absliq,
           zcw_cols)
    kw = dict(cloud_mh=cloud_mh, cloud_lm=cloud_lm, inhm=inhm,
              cwp_tiny=cwp_tiny, seed_order=seed_order)
    if not use_kernel(cldf):
        return mcica_optics_lw_plain(*ins, **kw)
    _require("mcica_optics_lw", ins[:6], (sigcls,), (absice, absliq),
             zcw_cols)
    if absice.shape != (*cldf.shape, 16) or absliq.shape != absice.shape:
        raise ValueError("mcica_optics_lw: absice, absliq must be "
                         "[ncol, nlay, 16]")
    out = launch(build.library(), *ins, cloud_mh, cloud_lm, inhm, cwp_tiny,
                 seed_order)
    build.LAUNCHES["mcica_optics_lw"] += 1
    return out


def mcica_subcols_raw_plain(keys, alpha, rcorr, cldf, *, nsub,
                            col_block=1024):
    """Plain PyTorch twin of K7: ops.mcica.subcolumns_raw in column
    blocks. Returns (cloudy, v3), each [ncol, nlay, nsub] float32."""
    parts = [subcolumns_raw(keys[s], alpha[s], rcorr[s], cldf[s], nsub)
             for s in column_blocks(cldf.shape[0], col_block)]
    return tuple(torch.cat(x) for x in zip(*parts))


def launch_raw(lib, keys, alpha, rcorr, cldf, nsub):
    """Allocate the outputs and launch K7 from lib; returns them."""
    ncol, nlay = cldf.shape
    outs = tuple(torch.empty((ncol, nlay, nsub), dtype=torch.float32,
                             device=cldf.device) for _ in range(2))
    k32 = _keys_u32(keys)    # held until the launch has read it
    fn = build.entry(lib, "mcica_subcols_raw", 6, 3)
    rc = fn(k32.data_ptr(), alpha.data_ptr(), rcorr.data_ptr(),
            cldf.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(), ncol,
            nlay, nsub, build.stream_of(cldf))
    build.check(rc, "mcica_subcols_raw")
    return outs


def mcica_subcols_raw(keys, alpha, rcorr, cldf, *, nsub):
    """K7: the raw subcolumn draws of the McICA generator (the presence
    mask and the forward-filled condensate cdf), as K1 and K2 draw them.

    keys [ncol, 4, 2] int64 (ops.mcica.subcolumn_keys); alpha, rcorr,
    cldf [ncol, nlay] f32. The plain twin unless
    kernels.twins.use_kernel; then the kernel. Returns (cloudy, v3), each
    [ncol, nlay, nsub] f32.
    """
    if not use_kernel(cldf):
        return mcica_subcols_raw_plain(keys, alpha, rcorr, cldf, nsub=nsub)
    build.require_cuda("mcica_subcols_raw", keys, alpha, rcorr, cldf)
    if any(t.dtype != torch.float32 for t in (alpha, rcorr, cldf)):
        raise TypeError("mcica_subcols_raw: float inputs must be float32")
    if keys.shape != (cldf.shape[0], 4, 2) or alpha.shape != cldf.shape \
            or rcorr.shape != cldf.shape or nsub <= 0:
        raise ValueError("mcica_subcols_raw: bad keys/field shape or nsub")
    out = launch_raw(build.library(), keys, alpha, rcorr, cldf, nsub)
    build.LAUNCHES["mcica_subcols_raw"] += 1
    return out


def mcica_optics_sw_plain(play, alpha, rcorr, cldf, ciwp, clwp, sigcls, rei,
                          rel, cloud, zcw_cols, *, cloud_mh, cloud_lm,
                          seed_order, inhm=1, cwp_tiny=1.0e-20,
                          col_block=1024):
    """Plain PyTorch twin of K2: the oracle's composition, subcolumn_keys
    -> band_optics_coeffs_sw -> subcolumns -> cldprmc_from_band_coeffs_sw.

    play [ncol, nlay] f32 (hPa, TOA first), seeding the subkeys in
    seed_order (the SW order is (3, 2, 1, 0)); alpha, rcorr, cldf, ciwp,
    clwp, rei, rel [ncol, nlay] f32; sigcls [ncol, nlay] int; cloud: the
    cldprmc_sw.CloudPackSW of the configured iceflag; zcw_cols (3, 1000)
    f32. Returns taucmc, ssacmc, asmcmc [ncol, nlay, 112] f32, cldymc
    [ncol, nlay, 112] bool, counts [ncol, 4] int32.
    """
    tables = unpack_cloud_tables_sw(cloud)
    outs = [], [], [], [], []
    for s in column_blocks(cldf.shape[0], col_block):
        cldy, ciwp_s, clwp_s = subcolumns(
            subcolumn_keys(play[s], seed_order), alpha[s], rcorr[s], cldf[s],
            ciwp[s], clwp[s], sigcls[s], zcw_cols, cwp_tiny, NGPTSW, inhm)
        coeffs = band_optics_coeffs_sw(rei[s], rel[s], tables,
                                       iceflag=cloud.iceflag)
        tau, ssa, asm, _ = cldprmc_from_band_coeffs_sw(cldy, ciwp_s, clwp_s,
                                                       coeffs)
        for o, x in zip(outs, (tau, ssa, asm, cldy)):
            o.append(x.transpose(-1, -2).contiguous())
        outs[4].append(clear_counts_three_band(cldy, cloud_mh, cloud_lm))
    return tuple(torch.cat(o) for o in outs)


def launch_sw(lib, play, alpha, rcorr, cldf, ciwp, clwp, sigcls, rei, rel,
              cloud, zcw_cols, cloud_mh, cloud_lm, inhm, cwp_tiny,
              seed_order):
    """Allocate the outputs and launch K2 from lib; returns them."""
    ncol, nlay = cldf.shape
    dev = cldf.device
    outs = (*(torch.empty((ncol, nlay, NGPTSW), dtype=torch.float32,
                          device=dev) for _ in range(3)),
            torch.empty((ncol, nlay, NGPTSW), dtype=torch.bool, device=dev),
            torch.empty((ncol, 4), dtype=torch.int32, device=dev))
    return _launch(
        lib, "mcica_optics_sw", (play, alpha, rcorr, cldf, ciwp, clwp),
        sigcls, (rei, rel, cloud.pack, zcw_cols), outs,
        (ncol, nlay, cloud_mh, cloud_lm, inhm, seed_order_bits(seed_order),
         cloud.iceflag, cloud.nice, cloud.nliq), cwp_tiny, cldf)


def _require_cloud(name, cloud):
    """K2's table contract: a CloudPackSW of iceflag 1-3 whose pack holds
    its tables."""
    if cloud.iceflag not in ICE_TABLE_KEYS:
        raise ValueError(f"{name}: iceflag {cloud.iceflag} does not exist "
                         f"for RRTMG-SW")
    rows = (len(ICE_TABLE_KEYS[cloud.iceflag]) * cloud.nice
            + len(LIQ_TABLE_KEYS) * cloud.nliq)
    if cloud.pack.shape != (rows * 14,) or cloud.nliq < 2 or (
            cloud.iceflag != 1 and cloud.nice < 2):
        raise ValueError(f"{name}: the cloud pack does not hold the tables "
                         f"of iceflag {cloud.iceflag}")


def mcica_optics_sw(play, alpha, rcorr, cldf, ciwp, clwp, sigcls, rei, rel,
                    cloud, zcw_cols, *, cloud_mh, cloud_lm, seed_order,
                    inhm=1, cwp_tiny=1.0e-20):
    """K2: McICA subcolumns + delta-scaled SW cloud optics + clear counts,
    the subkeys and the band optics evaluated in the kernel.

    The plain twin unless kernels.twins.use_kernel; then the kernel.
    Same arguments and results as mcica_optics_sw_plain.
    """
    ins = (play, alpha, rcorr, cldf, ciwp, clwp, sigcls, rei, rel, cloud,
           zcw_cols)
    kw = dict(cloud_mh=cloud_mh, cloud_lm=cloud_lm, seed_order=seed_order,
              inhm=inhm, cwp_tiny=cwp_tiny)
    if not use_kernel(cldf):
        return mcica_optics_sw_plain(*ins, **kw)
    _require("mcica_optics_sw", (play, alpha, rcorr, cldf, ciwp, clwp, rei,
                                 rel), (sigcls,), (cloud.pack,), zcw_cols)
    _require_cloud("mcica_optics_sw", cloud)
    out = launch_sw(build.library(), *ins, cloud_mh, cloud_lm, inhm,
                    cwp_tiny, seed_order)
    build.LAUNCHES["mcica_optics_sw"] += 1
    return out
