"""The plain PyTorch twins of the port's fused McICA + cloud optics
kernels K1 (LW) and K2 (SW): per column the four threefry subkeys from
its layer pressures and the seed order, the four uniforms per (column,
g-point, layer), the overlap fills, the zcw condensate scaling, the
band->g cloud optics and the four clear subcolumn counts.
"""

import torch

from ..models.rrtmg.cldprmc_lw import cldprmc_from_band_coeffs
from ..models.rrtmg.cldprmc_sw import (band_optics_coeffs_sw,
                                       cldprmc_from_band_coeffs_sw,
                                       unpack_cloud_tables_sw)
from .mcica import (clear_counts_three_band, column_blocks, subcolumn_keys,
                    subcolumns)

NGPTLW = 140
NGPTSW = 112
SEED_ORDER_LW = (0, 1, 2, 3)


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
