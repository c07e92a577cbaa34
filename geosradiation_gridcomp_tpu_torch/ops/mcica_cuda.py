"""Fused McICA + cloud optics: kernels K1 (LW) and K2 (SW), the raw draws
of kernel K7, and their plain twins.

K1 and K2 replace the TPU kernels geosradiation_gridcomp_tpu/ops/
mcica_pallas.py:mcica_optics_lw_fused and mcica_optics_sw_fused. Each
computes what the CPU oracle computes (generate_stochastic_clouds +
clear_counts_three_band + cldprmc_lw or cldprmc_sw): per (column,
g-point, layer) the four threefry uniforms, the two overlap forward
fills, the zcw condensate scaling from the exact class table, then the
band->g cloud optics, and the four clear subcolumn counts. K7 replaces
mcica_pallas.py:mcica_subcols_raw, the verification suite's raw draws.
The CUDA sources are csrc/mcica_lw.cu, csrc/mcica_sw.cu and
csrc/mcica_raw.cu; all three include the generator of csrc/mcica_gen.cuh.
"""

import torch

from ..kernels import build
from ..models.rrtmg.cldprmc_lw import cldprmc_from_band_coeffs
from ..models.rrtmg.cldprmc_sw import cldprmc_from_band_coeffs_sw
from .mcica import (clear_counts_three_band, column_blocks, subcolumns,
                    subcolumns_raw)

NGPTLW = 140
NGPTSW = 112


def mcica_optics_lw_plain(keys, alpha, rcorr, cldf, ciwp, clwp, sigcls,
                          absice, absliq, zcw_cols, *, cloud_mh, cloud_lm,
                          inhm=1, cwp_tiny=1.0e-20, col_block=1024):
    """Plain PyTorch twin of K1.

    keys [ncol, 4, 2] int64 (ops.mcica.subcolumn_keys); alpha, rcorr,
    cldf, ciwp, clwp [ncol, nlay] f32; sigcls [ncol, nlay] int;
    absice, absliq [ncol, nlay, 16] f32; zcw_cols (3, 1000) f32.
    Returns taucmc [ncol, nlay, 140], cloudy [ncol, nlay] bool,
    counts [ncol, 4] int32.
    """
    taus, clds, cnts = [], [], []
    for s in column_blocks(cldf.shape[0], col_block):
        cldy, ciwp_s, clwp_s = subcolumns(
            keys[s], alpha[s], rcorr[s], cldf[s], ciwp[s], clwp[s],
            sigcls[s], zcw_cols, cwp_tiny, NGPTLW, inhm)
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


def _launch(lib, name, keys, alpha, rcorr, cldf, ciwp, clwp, sigcls,
            optics, zcw_cols, outs, cloud_mh, cloud_lm, inhm, cwp_tiny):
    """Launch K1 or K2 (entry point `name`) from lib: the generator's
    inputs, the scheme's band optics planes, zcw, then its outputs."""
    ncol, nlay = cldf.shape
    args = (_keys_u32(keys), alpha, rcorr, cldf, ciwp, clwp,
            sigcls.to(torch.int32).contiguous(), *optics, zcw_cols, *outs)
    fn = build.entry(lib, name, len(args), 5, 1)
    rc = fn(*(t.data_ptr() for t in args), ncol, nlay, cloud_mh, cloud_lm,
            inhm, cwp_tiny, build.stream_of(cldf))
    build.check(rc, name)
    return outs


def _require(name, keys, alpha, rcorr, cldf, ciwp, clwp, sigcls, optics,
             optics_shape, zcw_cols):
    """The wrappers' contract: one CUDA device, contiguous, float32, and
    the shapes the kernel indexes with."""
    floats = (alpha, rcorr, cldf, ciwp, clwp, *optics, zcw_cols)
    build.require_cuda(name, keys, sigcls, *floats)
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"{name}: float inputs must be float32")
    if keys.shape != (cldf.shape[0], 4, 2) or any(
            o.shape != optics_shape for o in optics):
        raise ValueError(f"{name}: bad optics/keys shape")
    if zcw_cols.shape != (3, 1000):
        raise ValueError(f"{name}: zcw_cols must be (3, 1000)")


def launch(lib, keys, alpha, rcorr, cldf, ciwp, clwp, sigcls, absice,
           absliq, zcw_cols, cloud_mh, cloud_lm, inhm, cwp_tiny):
    """Allocate the outputs and launch K1 from lib; returns them."""
    ncol, nlay = cldf.shape
    dev = cldf.device
    outs = (torch.empty((ncol, nlay, NGPTLW), dtype=torch.float32,
                        device=dev),
            torch.empty((ncol, nlay), dtype=torch.uint8, device=dev),
            torch.empty((ncol, 4), dtype=torch.int32, device=dev))
    taucmc, cloudy, counts = _launch(
        lib, "mcica_optics_lw", keys, alpha, rcorr, cldf, ciwp, clwp, sigcls,
        (absice, absliq), zcw_cols, outs, cloud_mh, cloud_lm, inhm, cwp_tiny)
    return taucmc, cloudy.bool(), counts


def mcica_optics_lw(keys, alpha, rcorr, cldf, ciwp, clwp, sigcls, absice,
                    absliq, zcw_cols, *, cloud_mh, cloud_lm, inhm=1,
                    cwp_tiny=1.0e-20):
    """K1: McICA subcolumns + LW cloud optics + clear counts.

    CPU tensors take the plain twin; CUDA tensors launch the kernel.
    Same arguments and results as mcica_optics_lw_plain.
    """
    ins = (keys, alpha, rcorr, cldf, ciwp, clwp, sigcls, absice, absliq,
           zcw_cols)
    if cldf.device.type == "cpu":
        return mcica_optics_lw_plain(*ins, cloud_mh=cloud_mh,
                                     cloud_lm=cloud_lm, inhm=inhm,
                                     cwp_tiny=cwp_tiny)
    _require("mcica_optics_lw", *ins[:7], (absice, absliq),
             (*cldf.shape, 16), zcw_cols)
    out = launch(build.library(), *ins, cloud_mh, cloud_lm, inhm, cwp_tiny)
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
    cldf [ncol, nlay] f32. CPU tensors take the plain twin; CUDA tensors
    launch the kernel. Returns (cloudy, v3), each [ncol, nlay, nsub] f32.
    """
    if cldf.device.type == "cpu":
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


def mcica_optics_sw_plain(keys, alpha, rcorr, cldf, ciwp, clwp, sigcls,
                          coeffs, zcw_cols, *, cloud_mh, cloud_lm, inhm=1,
                          cwp_tiny=1.0e-20, col_block=1024):
    """Plain PyTorch twin of K2.

    keys [ncol, 4, 2] int64 (ops.mcica.subcolumn_keys with the SW seed
    order (3, 2, 1, 0)); alpha, rcorr, cldf, ciwp, clwp [ncol, nlay] f32;
    sigcls [ncol, nlay] int; coeffs [8, ncol, nlay, 14] f32, the planes
    of cldprmc_sw.band_optics_coeffs_sw; zcw_cols (3, 1000) f32.
    Returns taucmc, ssacmc, asmcmc [ncol, nlay, 112] f32, cldymc
    [ncol, nlay, 112] bool, counts [ncol, 4] int32.
    """
    outs = [], [], [], [], []
    for s in column_blocks(cldf.shape[0], col_block):
        cldy, ciwp_s, clwp_s = subcolumns(
            keys[s], alpha[s], rcorr[s], cldf[s], ciwp[s], clwp[s],
            sigcls[s], zcw_cols, cwp_tiny, NGPTSW, inhm)
        tau, ssa, asm, _ = cldprmc_from_band_coeffs_sw(
            cldy, ciwp_s, clwp_s, tuple(c[s] for c in coeffs))
        for o, x in zip(outs, (tau, ssa, asm, cldy)):
            o.append(x.transpose(-1, -2).contiguous())
        outs[4].append(clear_counts_three_band(cldy, cloud_mh, cloud_lm))
    return tuple(torch.cat(o) for o in outs)


def launch_sw(lib, keys, alpha, rcorr, cldf, ciwp, clwp, sigcls, coeffs,
              zcw_cols, cloud_mh, cloud_lm, inhm, cwp_tiny):
    """Allocate the outputs and launch K2 from lib; returns them."""
    ncol, nlay = cldf.shape
    dev = cldf.device
    outs = (*(torch.empty((ncol, nlay, NGPTSW), dtype=torch.float32,
                          device=dev) for _ in range(3)),
            torch.empty((ncol, nlay, NGPTSW), dtype=torch.bool, device=dev),
            torch.empty((ncol, 4), dtype=torch.int32, device=dev))
    return _launch(lib, "mcica_optics_sw", keys, alpha, rcorr, cldf, ciwp,
                   clwp, sigcls, (coeffs,), zcw_cols, outs, cloud_mh,
                   cloud_lm, inhm, cwp_tiny)


def mcica_optics_sw(keys, alpha, rcorr, cldf, ciwp, clwp, sigcls, coeffs,
                    zcw_cols, *, cloud_mh, cloud_lm, inhm=1,
                    cwp_tiny=1.0e-20):
    """K2: McICA subcolumns + delta-scaled SW cloud optics + clear counts.

    CPU tensors take the plain twin; CUDA tensors launch the kernel.
    Same arguments and results as mcica_optics_sw_plain.
    """
    ins = (keys, alpha, rcorr, cldf, ciwp, clwp, sigcls, coeffs, zcw_cols)
    if cldf.device.type == "cpu":
        return mcica_optics_sw_plain(*ins, cloud_mh=cloud_mh,
                                     cloud_lm=cloud_lm, inhm=inhm,
                                     cwp_tiny=cwp_tiny)
    _require("mcica_optics_sw", *ins[:7], (coeffs,),
             (8, *cldf.shape, 14), zcw_cols)
    out = launch_sw(build.library(), *ins, cloud_mh, cloud_lm, inhm,
                    cwp_tiny)
    build.LAUNCHES["mcica_optics_sw"] += 1
    return out
