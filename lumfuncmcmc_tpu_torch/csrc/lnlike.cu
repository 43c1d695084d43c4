// Single-epoch log-likelihood kernels for Hopper (sm_90a): the value
// kernels and their value + feature-gradient twins (the NUTS gradient
// path). The z model's kernels are in lnlike_z.cu; the sources share
// common.cuh (block size, block reduction, the ln fc terms, the value
// kernels' finish pass) and are compiled into one library by ops/_build.py.
//
// free_lnlike replaces the TPU kernels _kernel_free_bcast
// (lumfuncmcmc_tpu/ops/pallas_lnlike.py:601) and _kernel_free (:761);
// fixed_lnlike replaces _kernel_fixed_bcast (:751) and _kernel_fixed
// (:813). The TPU's broadcast/slab variants are two VMEM layouts of one
// computation; here one layout serves every catalog size.
// free_lnlike_vg replaces _kernel_free_vg (:832); fixed_lnlike_vg replaces
// _kernel_fixed_vg (:1255).
//
// What they compute, per walker w (feature row th = feats[w]):
//   free:  sum over fields f of
//            - sum_cells  exp(c_g + aA (a - lA) - P t1 + ln fc) * w
//            + sum_src    mask ? (c_s + aA (a - lA) - P t1 + lnOm0 + ln fc) : 0
//          ln fc = ln max(0.5 + 0.5 x rsqrt(1 + x^2), 1e-30), x = ac (logf - lF50_f),
//          divided by (1 - exp(-R t2_f)) when fcmin is set.
//   fixed: - sum_cells exp(c + aA (a - lA) - P t1) * w
//          (its collapsed source term is added on the host, in float64,
//          from the same rounded features: ops/cuda_lnlike.py
//          _fixed_collapsed)
// P = 10^(logL - lref) and R = 10^(logf + 16) are precomputed on the
// host, so the per-element work is 2 exp + 1 log + 1 rsqrt + 1 div (free)
// or 1 exp (fixed).
// The _vg kernels emit, per walker, that lnlike AND its derivative with
// respect to every feature of the row, in one pass over the cells:
//   free:  [lnl, d_cg, d_cs, d_aA, d_lA, d_t1, d_ac, d_lf50_f.., d_t2_f..]
//   fixed: [lnl, d_c, d_aA, d_lA, d_t1]
// The theta -> feature pullback is left to autograd of the cheap feature
// map (ops/cuda_lnlike.py: make_cuda_lnprob_and_grad). Per cell the
// derivative needs, beyond the forward's terms, only products of what the
// forward already computes: u = rsqrt(1 + x^2) is reused for u^3
// (d ln fc/dx = 0.5 u^3 / fc) and q = exp(-R t2) for the t2 derivative, so
// there is no transcendental beyond the value kernel's (the TPU kernel's
// own accounting, pallas_lnlike.py:841-843).
//
// What bounds them on the card: transcendental throughput and launch
// latency. At the stretch fit's shape (W = 50 walkers x 51,005 cells) one
// call is ~2.6 M cell evaluations: a few microseconds of SFU work, with
// the grid arrays (1 MB) resident in L2 across walkers. At the NUTS shape
// (W = 8 chains) a value+gradient call is ~0.4 M cell evaluations of ~50
// float32 operations each, a fraction of a microsecond at the card's peak
// rates: launch latency and the dependent transcendental chain per thread
// bound it; at W = 256 the SFU rate takes over. The design keeps the SMs
// busy at small W and stays deterministic:
//   - grid (nchunks, W): block (c, w) reduces chunk c (<= 2048 cells or
//     sources of one field, from the host chunk table (field, start, end,
//     is_source)) for walker w, so W = 50 already gives ~1,500 blocks for
//     132 SMs and W = 8 ~280;
//   - each thread accumulates K separate sums of its few terms in float32
//     registers (K = 1 for the value kernels, 7 free / 3 fixed for the _vg
//     ones), the block reduces all K in double with warp shuffles and one
//     shared-memory pass, and writes them to a (W, nchunks, K) double
//     scratch buffer the caller allocates;
//   - a second small kernel sums each walker's partials in fixed chunk
//     order (in double), routing each chunk's d_lf50/d_t2 terms to its
//     field's column, and writes float64: no float atomics, identical
//     results run to run, and the cancellation of d_cg + d_cs (~ -integral
//     + N near the mode) happens in double.
// Plain expf/logf/rsqrtf (no --use_fast_math), matching the plain PyTorch
// versions in ops/cuda_lnlike.py.

#include <cuda_runtime.h>

#include "common.cuh"

#define FREE_SLOTS 7     // ops/cuda_lnlike.py VG_FREE_SLOTS
#define FIXED_SLOTS 3    // ops/cuda_lnlike.py VG_FIXED_SLOTS

// ---------------------------------------------------------------------------
// value kernels
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
free_partials(const float* __restrict__ feats, int nfeat, int nfields,
              const float* __restrict__ g_logf, const float* __restrict__ g_a,
              const float* __restrict__ g_p, const float* __restrict__ g_r,
              const float* __restrict__ g_w,
              const float* __restrict__ s_logf, const float* __restrict__ s_a,
              const float* __restrict__ s_p, const float* __restrict__ s_r,
              const float* __restrict__ s_lnom0,
              const float* __restrict__ s_mask,
              const int4* __restrict__ chunks, int nchunks, int fcmin,
              double* __restrict__ partial) {
    const int c = blockIdx.x;
    const int w = blockIdx.y;
    const int4 ch = chunks[c];            // (field, start, end, is_source)
    const float* th = feats + (size_t)w * nfeat;
    const float aA = th[2], lA = th[3], t1 = th[4], ac = th[5];
    const float lf50 = th[6 + ch.x];
    const float t2 = th[6 + nfields + ch.x];
    float acc[1] = {0.0f};
    if (!ch.w) {
        const float c_g = th[0];
        for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS) {
            const float e = c_g + aA * (g_a[i] - lA) - g_p[i] * t1
                + ln_fc(g_logf[i], g_r[i], ac, lf50, t2, fcmin);
            acc[0] -= expf(e) * g_w[i];
        }
    } else {
        const float c_s = th[1];
        for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS) {
            if (s_mask[i] > 0.0f) {
                acc[0] += c_s + aA * (s_a[i] - lA) - s_p[i] * t1 + s_lnom0[i]
                    + ln_fc(s_logf[i], s_r[i], ac, lf50, t2, fcmin);
            }
        }
    }
    const double s = block_sum_f32_to_f64(acc[0]);
    if (threadIdx.x == 0) partial[(size_t)w * nchunks + c] = s;
}

__global__ void __launch_bounds__(THREADS)
fixed_partials(const float* __restrict__ feats, int nfeat,
               const float* __restrict__ g_a, const float* __restrict__ g_p,
               const float* __restrict__ g_w,
               const int4* __restrict__ chunks, int nchunks,
               double* __restrict__ partial) {
    const int c = blockIdx.x;
    const int w = blockIdx.y;
    const int4 ch = chunks[c];
    const float* th = feats + (size_t)w * nfeat;
    const float cg = th[0], aA = th[1], lA = th[2], t1 = th[3];
    float acc[1] = {0.0f};
    for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS)
        acc[0] -= expf(cg + aA * (g_a[i] - lA) - g_p[i] * t1) * g_w[i];
    const double s = block_sum_f32_to_f64(acc[0]);
    if (threadIdx.x == 0) partial[(size_t)w * nchunks + c] = s;
}

// ---------------------------------------------------------------------------
// value + gradient kernels
// ---------------------------------------------------------------------------

// Grid chunk slots:   [Se, Se*am, Se*P, Se*dfx*dl, Se*dfx, Se*dft, 0]
// Source chunk slots: [Scontrib, Sm, Sm*am, Sm*P, Sm*dfx*dl, Sm*dfx, Sm*dft]
// with am = a - lA, dl = logf - lF50_f, S over the chunk's cells.
__global__ void __launch_bounds__(THREADS)
free_vg_partials(const float* __restrict__ feats, int nfeat, int nfields,
                 const float* __restrict__ g_logf,
                 const float* __restrict__ g_a,
                 const float* __restrict__ g_p,
                 const float* __restrict__ g_r,
                 const float* __restrict__ g_w,
                 const float* __restrict__ s_logf,
                 const float* __restrict__ s_a,
                 const float* __restrict__ s_p,
                 const float* __restrict__ s_r,
                 const float* __restrict__ s_lnom0,
                 const float* __restrict__ s_mask,
                 const int4* __restrict__ chunks, int nchunks, int fcmin,
                 double* __restrict__ partial) {
    const int c = blockIdx.x;
    const int w = blockIdx.y;
    const int4 ch = chunks[c];            // (field, start, end, is_source)
    const float* th = feats + (size_t)w * nfeat;
    const float aA = th[2], lA = th[3], t1 = th[4], ac = th[5];
    const float lf50 = th[6 + ch.x];
    const float t2 = th[6 + nfields + ch.x];
    float acc[FREE_SLOTS];
#pragma unroll
    for (int k = 0; k < FREE_SLOTS; ++k) acc[k] = 0.0f;
    if (!ch.w) {
        const float c_g = th[0];
        for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS) {
            const float lf = g_logf[i];
            const FcTerms t = fc_terms(lf, g_r[i], ac, lf50, t2, fcmin);
            const float am = g_a[i] - lA;
            const float p = g_p[i];
            const float e = expf(c_g + aA * am - p * t1 + t.lnfc) * g_w[i];
            const float edfx = e * t.dfx;
            acc[0] += e;
            acc[1] += e * am;
            acc[2] += e * p;
            acc[3] += edfx * (lf - lf50);
            acc[4] += edfx;
            acc[5] += e * t.dft;
        }
    } else {
        const float c_s = th[1];
        for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS) {
            const float m = s_mask[i];
            if (m > 0.0f) {
                const float lf = s_logf[i];
                const FcTerms t = fc_terms(lf, s_r[i], ac, lf50, t2, fcmin);
                const float am = s_a[i] - lA;
                const float p = s_p[i];
                const float mdfx = m * t.dfx;
                acc[0] += c_s + aA * am - p * t1 + s_lnom0[i] + t.lnfc;
                acc[1] += m;
                acc[2] += m * am;
                acc[3] += m * p;
                acc[4] += mdfx * (lf - lf50);
                acc[5] += mdfx;
                acc[6] += m * t.dft;
            }
        }
    }
    double sums[FREE_SLOTS];
#pragma unroll
    for (int k = 0; k < FREE_SLOTS; ++k) sums[k] = acc[k];
    block_sum_k<FREE_SLOTS>(sums);
    if (threadIdx.x == 0) {
        double* out = partial + ((size_t)w * nchunks + c) * FREE_SLOTS;
#pragma unroll
        for (int k = 0; k < FREE_SLOTS; ++k) out[k] = sums[k];
    }
}

// Block w, thread col: out[w, col] summed over the chunks in order, in
// double. Columns: 0 lnl, 1 d_cg, 2 d_cs, 3 d_aA, 4 d_lA, 5 d_t1, 6 d_ac,
// 7+f d_lf50_f, 7+F+f d_t2_f. Each column takes one slot of a grid chunk
// and one of a source chunk, times a multiplier (0: no term), so every
// thread runs the same branch-free walk over the chunks; the walker's
// partials and the chunk table are staged in shared memory, tile by
// tile, with coalesced loads.
__global__ void free_vg_finish(const double* __restrict__ partial,
                               const int4* __restrict__ chunks, int nchunks,
                               const float* __restrict__ feats, int nfeat,
                               int nfields, double* __restrict__ out) {
    __shared__ double tile[FINISH_TILE * FREE_SLOTS];
    __shared__ int tile_field[FINISH_TILE];
    __shared__ int tile_src[FINISH_TILE];
    const int w = blockIdx.x;
    const int col = threadIdx.x;
    const int ncols = 1 + nfeat;
    const float* th = feats + (size_t)w * nfeat;
    const double aA = th[2], ac = th[5];
    const int field = col < 7 ? -1 : (col - 7) % nfields;
    // (grid slot, multiplier), (source slot, multiplier) of this column
    int gk = 0, sk = 0;
    double gm = 0.0, sm = 0.0;
    switch (col < 7 ? col : (col < 7 + nfields ? 7 : 8)) {
        case 0: gm = -1.0; sm = 1.0; break;                 // lnl
        case 1: gm = -1.0; break;                           // d_cg
        case 2: sk = 1; sm = 1.0; break;                    // d_cs
        case 3: gk = 1; gm = -1.0; sk = 2; sm = 1.0; break; // d_aA
        case 4: gm = aA; sk = 1; sm = -aA; break;           // d_lA
        case 5: gk = 2; gm = 1.0; sk = 3; sm = -1.0; break; // d_t1
        case 6: gk = 3; gm = -1.0; sk = 4; sm = 1.0; break; // d_ac
        case 7: gk = 4; gm = ac; sk = 5; sm = -ac; break;   // d_lf50_f
        default: gk = 5; gm = -1.0; sk = 6; sm = 1.0;       // d_t2_f
    }
    const double* pw = partial + (size_t)w * nchunks * FREE_SLOTS;
    double s = 0.0;
    for (int c0 = 0; c0 < nchunks; c0 += FINISH_TILE) {
        const int n = min(FINISH_TILE, nchunks - c0);
        __syncthreads();
        for (int i = threadIdx.x; i < n * FREE_SLOTS; i += blockDim.x)
            tile[i] = pw[(size_t)c0 * FREE_SLOTS + i];
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int4 ch = chunks[c0 + i];
            tile_field[i] = ch.x;
            tile_src[i] = ch.w;
        }
        __syncthreads();
        for (int c = 0; c < n; ++c) {
            const bool src = tile_src[c] != 0;
            const double m = src ? sm : gm;
            if (m != 0.0 && (field < 0 || tile_field[c] == field))
                s += m * tile[c * FREE_SLOTS + (src ? sk : gk)];
        }
    }
    if (col < ncols) out[(size_t)w * ncols + col] = s;
}

// Slots: [Se, Se*am, Se*P].
__global__ void __launch_bounds__(THREADS)
fixed_vg_partials(const float* __restrict__ feats, int nfeat,
                  const float* __restrict__ g_a,
                  const float* __restrict__ g_p,
                  const float* __restrict__ g_w,
                  const int4* __restrict__ chunks, int nchunks,
                  double* __restrict__ partial) {
    const int c = blockIdx.x;
    const int w = blockIdx.y;
    const int4 ch = chunks[c];
    const float* th = feats + (size_t)w * nfeat;
    const float cg = th[0], aA = th[1], lA = th[2], t1 = th[3];
    float acc[FIXED_SLOTS] = {0.0f, 0.0f, 0.0f};
    for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS) {
        const float am = g_a[i] - lA;
        const float p = g_p[i];
        const float e = expf(cg + aA * am - p * t1) * g_w[i];
        acc[0] += e;
        acc[1] += e * am;
        acc[2] += e * p;
    }
    double sums[FIXED_SLOTS] = {acc[0], acc[1], acc[2]};
    block_sum_k<FIXED_SLOTS>(sums);
    if (threadIdx.x == 0) {
        double* out = partial + ((size_t)w * nchunks + c) * FIXED_SLOTS;
#pragma unroll
        for (int k = 0; k < FIXED_SLOTS; ++k) out[k] = sums[k];
    }
}

// Block w: out[w] = [-S0, -S0, -S1, aA S0, S2]; thread k < 3 sums slot k
// over the chunks in order, in double, from tiles staged in shared memory
// as in free_vg_finish.
__global__ void fixed_vg_finish(const double* __restrict__ partial,
                                int nchunks,
                                const float* __restrict__ feats, int nfeat,
                                double* __restrict__ out) {
    __shared__ double tile[FINISH_TILE * FIXED_SLOTS];
    __shared__ double sums[FIXED_SLOTS];
    const int w = blockIdx.x;
    const int k = threadIdx.x;
    const double* pw = partial + (size_t)w * nchunks * FIXED_SLOTS;
    double s = 0.0;
    for (int c0 = 0; c0 < nchunks; c0 += FINISH_TILE) {
        const int n = min(FINISH_TILE, nchunks - c0);
        __syncthreads();
        for (int i = threadIdx.x; i < n * FIXED_SLOTS; i += blockDim.x)
            tile[i] = pw[(size_t)c0 * FIXED_SLOTS + i];
        __syncthreads();
        if (k < FIXED_SLOTS)
            for (int c = 0; c < n; ++c) s += tile[c * FIXED_SLOTS + k];
    }
    if (k < FIXED_SLOTS) sums[k] = s;
    __syncthreads();
    if (k == 0) {
        const float* th = feats + (size_t)w * nfeat;
        double* o = out + (size_t)w * 5;
        o[0] = -sums[0];
        o[1] = -sums[0];
        o[2] = -sums[1];
        o[3] = (double)th[1] * sums[0];
        o[4] = sums[2];
    }
}

extern "C" {

// All pointers are device pointers; the stream is a cudaStream_t. Returns
// the cudaError_t of the launches (0 = success). Allocates nothing: the
// caller passes a (W, nchunks, K) double partial buffer (K = 1 for the
// value kernels, FREE_SLOTS / FIXED_SLOTS for the _vg ones) and the double
// output, (W,) or (W, 1 + nfeat).
int free_lnlike_launch(const float* feats, int nwalkers, int nfeat,
                       int nfields,
                       const float* g_logf, const float* g_a,
                       const float* g_p, const float* g_r, const float* g_w,
                       const float* s_logf, const float* s_a,
                       const float* s_p, const float* s_r,
                       const float* s_lnom0, const float* s_mask,
                       const int* chunks, int nchunks, int fcmin,
                       double* partial, double* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid(nchunks, nwalkers);
    free_partials<<<grid, THREADS, 0, st>>>(
        feats, nfeat, nfields, g_logf, g_a, g_p, g_r, g_w, s_logf, s_a, s_p,
        s_r, s_lnom0, s_mask, (const int4*)chunks, nchunks, fcmin, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    finish<<<(nwalkers + 127) / 128, 128, 0, st>>>(partial, nchunks,
                                                   nwalkers, out);
    return (int)cudaGetLastError();
}

int fixed_lnlike_launch(const float* feats, int nwalkers, int nfeat,
                        const float* g_a, const float* g_p, const float* g_w,
                        const int* chunks, int nchunks,
                        double* partial, double* out, void* stream) {
    if (nfeat != 4) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid(nchunks, nwalkers);
    fixed_partials<<<grid, THREADS, 0, st>>>(
        feats, nfeat, g_a, g_p, g_w, (const int4*)chunks, nchunks, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    finish<<<(nwalkers + 127) / 128, 128, 0, st>>>(partial, nchunks,
                                                   nwalkers, out);
    return (int)cudaGetLastError();
}

int free_lnlike_vg_launch(const float* feats, int nwalkers, int nfeat,
                          int nfields,
                          const float* g_logf, const float* g_a,
                          const float* g_p, const float* g_r,
                          const float* g_w,
                          const float* s_logf, const float* s_a,
                          const float* s_p, const float* s_r,
                          const float* s_lnom0, const float* s_mask,
                          const int* chunks, int nchunks, int fcmin,
                          double* partial, double* out, void* stream) {
    const int ncols = 1 + nfeat;
    if (ncols > 1024 || nfeat != 6 + 2 * nfields)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid(nchunks, nwalkers);
    free_vg_partials<<<grid, THREADS, 0, st>>>(
        feats, nfeat, nfields, g_logf, g_a, g_p, g_r, g_w, s_logf, s_a, s_p,
        s_r, s_lnom0, s_mask, (const int4*)chunks, nchunks, fcmin, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    free_vg_finish<<<nwalkers, (ncols + 31) / 32 * 32, 0, st>>>(
        partial, (const int4*)chunks, nchunks, feats, nfeat, nfields, out);
    return (int)cudaGetLastError();
}

int fixed_lnlike_vg_launch(const float* feats, int nwalkers, int nfeat,
                           const float* g_a, const float* g_p,
                           const float* g_w,
                           const int* chunks, int nchunks,
                           double* partial, double* out, void* stream) {
    if (nfeat != 4) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid(nchunks, nwalkers);
    fixed_vg_partials<<<grid, THREADS, 0, st>>>(
        feats, nfeat, g_a, g_p, g_w, (const int4*)chunks, nchunks, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    fixed_vg_finish<<<nwalkers, 32, 0, st>>>(partial, nchunks, feats, nfeat,
                                            out);
    return (int)cudaGetLastError();
}

}  // extern "C"
