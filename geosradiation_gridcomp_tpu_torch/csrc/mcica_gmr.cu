// K8: RRTMGP's McICA draws, GEN_MAX_RAN_OVERLAP with condensate
// inhomogeneity (GEOS_SolarGridComp.F90:5186-5299).
//
// Computes what models/rrtmgp/scheme.py:_gen_max_ran_mask, its plain twin,
// computes, bit for bit: each column's state key (ops/mcica.py:
// state_seed_key, the default seed order; mcica_gen.cuh:column_state_key),
// the uniforms of threefry.uniform(key, (4, ngpt, nlay)) (field f at
// (g, l) from counter (f * ngpt + g) * nlay + l), the generalised
// max-random chain of the presence draws (field 0, kept from the layer
// above where field 1 < alpha) and of the condensate draws (fields 2 and
// 3 with rcorr), the mask u < cldf where cldf > 0, and zcw from the
// (3, 1000) class table at the sigma class of cldf (1 where there is no
// table, inhm 0; 0 wherever the mask is false).
//
// Bound on the H100: integer ALU, up to 4 threefry calls of 20 rounds per
// (column, g-point, layer), then writing the mask and zcw (5 B per cell).
// Design: one block per column, one thread per g-point (a block of ngpt
// rounded up to a warp: 128 threads for 112 g-points, 160 for 140, so
// under 15 % of the lanes idle); each thread draws its uniforms on the fly
// and carries both chains down the layers in registers, so the random
// fields never touch memory. The prologue stages the column's cldf, alpha
// and rcorr rows and the class table in shared memory, and one thread
// derives the column's key and its lowest cloudy layer. Layers below that
// one, and every layer of a clear column, take no draws: their mask is
// false whatever is drawn, so they are written as false and 0. The stores
// of each layer are coalesced along g.

#include "mcica_gen.cuh"

namespace {

using namespace geosrad;

constexpr int MAX_BLOCK = 256;
// ops/mcica.py's default seed order (0, 1, 2, 3), entry j at bits 2j
constexpr int SEED_ORDER = 0 | (1 << 2) | (2 << 4) | (3 << 6);

__global__ void __launch_bounds__(MAX_BLOCK)
mcica_gmr_kernel(const float* __restrict__ play,
                 const float* __restrict__ alpha,
                 const float* __restrict__ rcorr,
                 const float* __restrict__ cldf,
                 const float* __restrict__ zcw_cols,
                 unsigned char* __restrict__ mask,
                 float* __restrict__ zcw, int nlay, int ngpt, int cond) {
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    float* cf = reinterpret_cast<float*>(dyn_smem);     // [nlay]
    float* al = cf + nlay;                               // [nlay]
    float* rc = al + nlay;                               // [nlay]
    float* tab = rc + nlay;                              // [3 * 1000]
    __shared__ uint32_t key[2];
    __shared__ int depth;

    const int t = threadIdx.x;
    const size_t row = static_cast<size_t>(blockIdx.x) * nlay;
    for (int l = t; l < nlay; l += blockDim.x) {
        cf[l] = cldf[row + l];
        al[l] = alpha[row + l];
        rc[l] = rcorr[row + l];
    }
    if (cond)
        for (int i = t; i < 3 * ZCW_N1; i += blockDim.x) tab[i] = zcw_cols[i];
    __syncthreads();
    if (t == 0) {
        // the layers from the top through the lowest cloudy one
        int d = nlay;
        while (d > 0 && !(cf[d - 1] > 0.0f)) --d;
        depth = d;
        if (d > 0) {
            const Words k = column_state_key(play + row, nlay, SEED_ORDER);
            key[0] = k.w0;
            key[1] = k.w1;
        }
    }
    __syncthreads();
    const int d = depth;
    const uint32_t k0 = d > 0 ? key[0] : 0u, k1 = d > 0 ? key[1] : 0u;
    const uint32_t plane = static_cast<uint32_t>(ngpt * nlay);

    for (int g = t; g < ngpt; g += blockDim.x) {
        unsigned char* m_out = mask + row * ngpt + g;
        float* z_out = zcw + row * ngpt + g;
        float u = 0.0f, uc = 0.0f;
        for (int l = 0; l < d; ++l) {
            const uint32_t ctr = static_cast<uint32_t>(g * nlay + l);
            const float u0 = unit_float(threefry_bits(k0, k1, ctr));
            if (l == 0) {
                u = u0;
            } else {
                const float u1 =
                    unit_float(threefry_bits(k0, k1, ctr + plane));
                u = u1 < al[l] ? u : u0;
            }
            const float c = cf[l];
            const bool m = u < c && c > 0.0f;
            float z = m ? 1.0f : 0.0f;
            if (cond) {
                const float u2 =
                    unit_float(threefry_bits(k0, k1, ctr + 2u * plane));
                if (l == 0) {
                    uc = u2;
                } else {
                    const float u3 =
                        unit_float(threefry_bits(k0, k1, ctr + 3u * plane));
                    uc = u3 < rc[l] ? uc : u2;
                }
                if (m) z = zcw_lookup(tab, (c <= 0.99f) + (c <= 0.9f), uc);
            }
            m_out[static_cast<size_t>(l) * ngpt] = m ? 1 : 0;
            z_out[static_cast<size_t>(l) * ngpt] = z;
        }
        for (int l = d; l < nlay; ++l) {
            m_out[static_cast<size_t>(l) * ngpt] = 0;
            z_out[static_cast<size_t>(l) * ngpt] = 0.0f;
        }
    }
}

}  // namespace

extern "C" int mcica_gmr(const float* play, const float* alpha,
                         const float* rcorr, const float* cldf,
                         const float* zcw_cols, unsigned char* mask,
                         float* zcw, int ncol, int nlay, int ngpt, int cond,
                         void* stream) {
    const size_t smem = sizeof(float) * (3 * static_cast<size_t>(nlay)
                                         + (cond ? 3 * ZCW_N1 : 0));
    if (ncol <= 0 || nlay < 4 || ngpt <= 0 || smem > 48 * 1024)
        return static_cast<int>(cudaErrorInvalidValue);
    int block = (ngpt + 31) / 32 * 32;
    if (block > MAX_BLOCK) block = MAX_BLOCK;
    mcica_gmr_kernel<<<ncol, block, smem, static_cast<cudaStream_t>(stream)>>>(
        play, alpha, rcorr, cldf, zcw_cols, mask, zcw, nlay, ngpt, cond);
    return static_cast<int>(cudaGetLastError());
}
