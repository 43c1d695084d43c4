// Redshift-evolving log-likelihood kernels for Hopper (sm_90a): the value
// kernel and its value + feature-gradient twin (the NUTS gradient path of
// the z model). A second source of the one kernel library: ops/_build.py
// compiles it together with lnlike.cu, with which it shares common.cuh.
//
// z_lnlike replaces the TPU kernels _kernel_z_bcast
// (lumfuncmcmc_tpu/ops/pallas_lnlike.py:659) and _kernel_z2_slab (:677):
// two VMEM layouts of one function there, one kernel here, in the slab
// kernel's factoring. z_lnlike_vg replaces _kernel_z_vg (:1142).
//
// What they compute, per walker w (feature row th = feats[w], 7 floats, see
// _feat_z_one in ops/cuda_lnlike.py), with dz = z - z2 the offset from the
// central pivot and luminosities relative to lref:
//   per z node:  lq = th3 dz^2 + th4 dz + th5    LN10 (Lstar(z) - lref)
//                pr = th0 dz^2 + th1 dz + th2    LN10 phistar(z) + ln ln10
//                t1 = exp(-lq)                   10^(lref - Lstar(z))
//                base = pr - th6 lq              (in double, then hi + lo)
//   lnl = - sum_cells exp(base + th6 a - P t1) * w
//         + sum_src   mask ? (pr_s + th6 x - exp(x) + lnOm_s) : 0,
//                     x = a_s - lq_s at the source's own dz
// a = LN10 (logL - lref) and P = 10^(logL - lref) are precomputed on the
// host, so a cell costs one exp and the node quantities one more per z node
// and band of L rows. z_lnlike_vg emits [lnl, d lnl/d th0..th6]: the
// derivatives factor over the L rows, so per z node three running sums
// (E, E P, E a) are contracted with dz, dz^2, t1 and lq at the end of the
// column, and a cell costs two multiplies more than in the value kernel
// (the TPU kernel's own accounting, pallas_lnlike.py:1152-1156). Its source
// part clamps x at 60, as the TPU kernel does; the value kernel does not.
//
// What bounds them on the card: at the fit's shape (5 fields x 201 x 201
// cells, W = 50 walkers per stretch half-step, W = 8 NUTS chains) a call is
// 1.6-10 M cell evaluations of 7-11 float32 operations, a few microseconds
// at the card's peak, over 2.4 MB of grid arrays that stay in L2 across
// walkers: launch latency and the dependent exp chain per thread bound it,
// not bytes. The design follows lnlike.cu:
//   - the grid is (F, S_L, S_z) with z contiguous. A block takes one chunk
//     of the host table (field, start, end, is_source): a band of L rows
//     [start, end) of one field for one walker. Thread j owns z node j, forms
//     the node quantities once and walks down the band, so neighbouring
//     threads read neighbouring addresses; bands of ~2048 cells give
//     105 x W grid blocks at 201 x 201, ~840 at W = 8 for 132 SMs;
//   - source chunks (<= 2048 sources) take one term per source;
//   - each thread keeps K float32 sums of its few terms in registers (K =
//     1, or 8 for _vg; a z node's column of up to ~64 cells of ~200 each
//     at gauss-32 is summed with Kahan's compensation and added to the
//     value in double), the block reduces them in double with warp
//     shuffles and writes them to a (W, nchunks, K) double scratch buffer;
//     a second small kernel sums each walker's partials in fixed chunk
//     order in double and writes float64: no float atomics, identical
//     results run to run. The source terms are summed here, beside the
//     grid integral, from the same features, so the two parts, which
//     cancel to O(1) out of ~N near the mode, read the same numbers; at
//     10^5 sources |lnL| ~ 1e6, so the sums and the value are double.
// Plain expf (no --use_fast_math), matching the plain PyTorch versions in
// ops/cuda_lnlike.py.

#include <cuda_runtime.h>

#include "common.cuh"

#define Z_SLOTS 8        // ops/cuda_lnlike.py VG_Z_SLOTS
#define X_CLAMP 60.0f    // ops/cuda_lnlike.py X_CLAMP

// A z node's hoisted quantities, formed in double from the features and
// rounded once (ops/cuda_lnlike.py _z_node_rows): lq, t1 = exp(-lq) and
// base = pr - aA lq as hi + lo, added to a cell's exponent last, so the
// node's rounding error, which every cell of its column shares, stays at
// float32's precision of the whole exponent and not of base.
struct ZNode {
    float lq, t1, hi, lo;
};

__device__ __forceinline__ ZNode z_node(const float* th, float dz,
                                        float dz2) {
    const double z1 = dz, z2 = dz2;
    const double lq = (double)th[3] * z2 + (double)th[4] * z1 + (double)th[5];
    const double base = (double)th[0] * z2 + (double)th[1] * z1
        + (double)th[2] - (double)th[6] * lq;
    const float lqf = (float)lq, hi = (float)base;
    return {lqf, expf(-lqf), hi, (float)(base - (double)hi)};
}

__device__ __forceinline__ float z_cell(const ZNode& n, float aA, float a,
                                        float p) {
    return expf(n.hi + ((aA * a - p * n.t1) + n.lo));
}

__global__ void __launch_bounds__(THREADS)
z_partials(const float* __restrict__ feats, int nfeat, int s_l, int s_z,
           const float* __restrict__ g_a, const float* __restrict__ g_p,
           const float* __restrict__ g_w, const float* __restrict__ n_dz,
           const float* __restrict__ n_dz2, const float* __restrict__ s_a,
           const float* __restrict__ s_dz, const float* __restrict__ s_dz2,
           const float* __restrict__ s_lnom0,
           const float* __restrict__ s_mask,
           const int4* __restrict__ chunks, int nchunks,
           double* __restrict__ partial) {
    const int c = blockIdx.x;
    const int w = blockIdx.y;
    const int4 ch = chunks[c];            // (field, start, end, is_source)
    const float* th = feats + (size_t)w * nfeat;
    const float aA = th[6];
    double acc = 0.0;
    if (!ch.w) {
        const size_t panel = (size_t)ch.x * s_l * s_z;
        for (int j = threadIdx.x; j < s_z; j += THREADS) {
            const ZNode n = z_node(th, n_dz[ch.x * s_z + j],
                                   n_dz2[ch.x * s_z + j]);
            float col = 0.0f, comp = 0.0f;
            for (int r = ch.y; r < ch.z; ++r) {
                const size_t i = panel + (size_t)r * s_z + j;
                kahan_add(col, comp, z_cell(n, aA, g_a[i], g_p[i]) * g_w[i]);
            }
            acc -= (double)col - (double)comp;
        }
    } else {
        float src = 0.0f;
        for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS) {
            if (s_mask[i] > 0.0f) {
                const float dz = s_dz[i], dz2 = s_dz2[i];
                const float x = s_a[i]
                    - (th[3] * dz2 + th[4] * dz + th[5]);
                src += th[0] * dz2 + th[1] * dz + th[2] + aA * x
                    - expf(x) + s_lnom0[i];
            }
        }
        acc = src;
    }
    double sum[1] = {acc};
    block_sum_k<1>(sum);
    if (threadIdx.x == 0) partial[(size_t)w * nchunks + c] = sum[0];
}

// Grid chunk slots:   [SE, SE dz, SE dz^2, S(Ea - lq E), St1 EP, St1 EP dz,
//                      St1 EP dz^2, 0], sums over the band's cells, the
//                      contraction with the node's dz, lq, t1 done per column.
// Source chunk slots: [Scontrib, Sm, Sm dz, Sm dz^2, Sm x, Sm r, Sm r dz,
//                      Sm r dz^2], r = th6 - exp(x), x clamped at X_CLAMP.
__global__ void __launch_bounds__(THREADS)
z_vg_partials(const float* __restrict__ feats, int nfeat, int s_l, int s_z,
              const float* __restrict__ g_a, const float* __restrict__ g_p,
              const float* __restrict__ g_w, const float* __restrict__ n_dz,
              const float* __restrict__ n_dz2, const float* __restrict__ s_a,
              const float* __restrict__ s_dz,
              const float* __restrict__ s_dz2,
              const float* __restrict__ s_lnom0,
              const float* __restrict__ s_mask,
              const int4* __restrict__ chunks, int nchunks,
              double* __restrict__ partial) {
    const int c = blockIdx.x;
    const int w = blockIdx.y;
    const int4 ch = chunks[c];            // (field, start, end, is_source)
    const float* th = feats + (size_t)w * nfeat;
    const float aA = th[6];
    float acc[Z_SLOTS];
#pragma unroll
    for (int k = 0; k < Z_SLOTS; ++k) acc[k] = 0.0f;
    double val = 0.0;       // slot 0 (the value) in double
    if (!ch.w) {
        const size_t panel = (size_t)ch.x * s_l * s_z;
        for (int j = threadIdx.x; j < s_z; j += THREADS) {
            const float dz = n_dz[ch.x * s_z + j];
            const float dz2 = n_dz2[ch.x * s_z + j];
            const ZNode n = z_node(th, dz, dz2);
            float col_e = 0.0f, comp = 0.0f, col_ep = 0.0f, col_ea = 0.0f;
            for (int r = ch.y; r < ch.z; ++r) {
                const size_t i = panel + (size_t)r * s_z + j;
                const float a = g_a[i];
                const float p = g_p[i];
                const float e = z_cell(n, aA, a, p) * g_w[i];
                kahan_add(col_e, comp, e);
                col_ep += e * p;
                col_ea += e * a;
            }
            const float tp = n.t1 * col_ep;
            val += (double)col_e - (double)comp;
            acc[1] += col_e * dz;
            acc[2] += col_e * dz2;
            acc[3] += col_ea - n.lq * col_e;
            acc[4] += tp;
            acc[5] += tp * dz;
            acc[6] += tp * dz2;
        }
    } else {
        for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS) {
            const float m = s_mask[i];
            if (m > 0.0f) {
                const float dz = s_dz[i], dz2 = s_dz2[i];
                const float x = fminf(
                    s_a[i] - (th[3] * dz2 + th[4] * dz + th[5]), X_CLAMP);
                const float ex = expf(x);
                const float mr = m * (aA - ex);
                acc[0] += th[0] * dz2 + th[1] * dz + th[2] + aA * x - ex
                    + s_lnom0[i];      // per thread in float
                acc[1] += m;
                acc[2] += m * dz;
                acc[3] += m * dz2;
                acc[4] += m * x;
                acc[5] += mr;
                acc[6] += mr * dz;
                acc[7] += mr * dz2;
            }
        }
    }
    double sums[Z_SLOTS];
#pragma unroll
    for (int k = 0; k < Z_SLOTS; ++k) sums[k] = acc[k];
    sums[0] += val;
    block_sum_k<Z_SLOTS>(sums);
    if (threadIdx.x == 0) {
        double* out = partial + ((size_t)w * nchunks + c) * Z_SLOTS;
#pragma unroll
        for (int k = 0; k < Z_SLOTS; ++k) out[k] = sums[k];
    }
}

// Block w: thread k < 8 sums slot k over the grid chunks (G_k) and over the
// source chunks (S_k) in chunk order, in double, from tiles staged in
// shared memory as in lnlike.cu's finish kernels; thread 0 then writes
//   out[w] = [-G0 + S0,
//             -G2 + S3, -G1 + S2, -G0 + S1,
//             th6 G2 - G6 - S7, th6 G1 - G5 - S6, th6 G0 - G4 - S5,
//             -G3 + S4].
__global__ void z_vg_finish(const double* __restrict__ partial,
                            const int4* __restrict__ chunks, int nchunks,
                            const float* __restrict__ feats, int nfeat,
                            double* __restrict__ out) {
    __shared__ double tile[FINISH_TILE * Z_SLOTS];
    __shared__ int tile_src[FINISH_TILE];
    __shared__ double gs[Z_SLOTS], ss[Z_SLOTS];
    const int w = blockIdx.x;
    const int k = threadIdx.x;
    const double* pw = partial + (size_t)w * nchunks * Z_SLOTS;
    double g = 0.0, s = 0.0;
    for (int c0 = 0; c0 < nchunks; c0 += FINISH_TILE) {
        const int n = min(FINISH_TILE, nchunks - c0);
        __syncthreads();
        for (int i = threadIdx.x; i < n * Z_SLOTS; i += blockDim.x)
            tile[i] = pw[(size_t)c0 * Z_SLOTS + i];
        for (int i = threadIdx.x; i < n; i += blockDim.x)
            tile_src[i] = chunks[c0 + i].w;
        __syncthreads();
        if (k < Z_SLOTS) {
            for (int c = 0; c < n; ++c) {
                const double v = tile[c * Z_SLOTS + k];
                if (tile_src[c]) s += v; else g += v;
            }
        }
    }
    if (k < Z_SLOTS) {
        gs[k] = g;
        ss[k] = s;
    }
    __syncthreads();
    if (k == 0) {
        const double aA = (double)feats[(size_t)w * nfeat + 6];
        double* o = out + (size_t)w * 8;
        o[0] = -gs[0] + ss[0];
        o[1] = -gs[2] + ss[3];
        o[2] = -gs[1] + ss[2];
        o[3] = -gs[0] + ss[1];
        o[4] = aA * gs[2] - gs[6] - ss[7];
        o[5] = aA * gs[1] - gs[5] - ss[6];
        o[6] = aA * gs[0] - gs[4] - ss[5];
        o[7] = -gs[3] + ss[4];
    }
}

extern "C" {

// All pointers are device pointers; the stream is a cudaStream_t. Returns
// the cudaError_t of the launches (0 = success). Allocates nothing: the
// caller passes a (W, nchunks, K) double partial buffer (K = 1, or Z_SLOTS
// for _vg) and the double output, (W,) or (W, 8).
int z_lnlike_launch(const float* feats, int nwalkers, int nfeat, int s_l,
                    int s_z,
                    const float* g_a, const float* g_p, const float* g_w,
                    const float* n_dz, const float* n_dz2,
                    const float* s_a, const float* s_dz, const float* s_dz2,
                    const float* s_lnom0, const float* s_mask,
                    const int* chunks, int nchunks,
                    double* partial, double* out, void* stream) {
    if (nfeat != 7) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid(nchunks, nwalkers);
    z_partials<<<grid, THREADS, 0, st>>>(
        feats, nfeat, s_l, s_z, g_a, g_p, g_w, n_dz, n_dz2, s_a, s_dz, s_dz2,
        s_lnom0, s_mask, (const int4*)chunks, nchunks, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    finish<<<(nwalkers + 127) / 128, 128, 0, st>>>(partial, nchunks,
                                                   nwalkers, out);
    return (int)cudaGetLastError();
}

int z_lnlike_vg_launch(const float* feats, int nwalkers, int nfeat, int s_l,
                       int s_z,
                       const float* g_a, const float* g_p, const float* g_w,
                       const float* n_dz, const float* n_dz2,
                       const float* s_a, const float* s_dz,
                       const float* s_dz2,
                       const float* s_lnom0, const float* s_mask,
                       const int* chunks, int nchunks,
                       double* partial, double* out, void* stream) {
    if (nfeat != 7) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid(nchunks, nwalkers);
    z_vg_partials<<<grid, THREADS, 0, st>>>(
        feats, nfeat, s_l, s_z, g_a, g_p, g_w, n_dz, n_dz2, s_a, s_dz, s_dz2,
        s_lnom0, s_mask, (const int4*)chunks, nchunks, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    z_vg_finish<<<nwalkers, 32, 0, st>>>(
        partial, (const int4*)chunks, nchunks, feats, nfeat, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
