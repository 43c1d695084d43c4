// Streaming free-completeness kernels for mega catalogs (10^5 - 10^6
// sources): free_stream_lnlike replaces the TPU kernel _kernel_free_stream
// (lumfuncmcmc_tpu/ops/pallas_lnlike.py:941, also reached through
// make_stream_shard_batched, :404); free_stream_lnlike_vg replaces
// _kernel_free_stream_vg (:1009, and make_stream_shard_vg, :1711).
//
// What they compute, per walker w (feature row th = feats[w], the layout of
// ops/cuda_lnlike.py _features_stream: logf and lF50 relative to
// logf_ref = -16), for one shard of the sources:
//     sum over source tiles    sum_src  mask ln fc(logf; ac, lF50_f, t2_f)
//   - sum over grid chunks     sum_cell exp(c_g + aA (a - lA) - P t1 + ln fc) w
// with the grid weights already divided by the shard count. The
// theta-affine source terms (ln phi's N c_s + aA sum(a - lA) - t1 sum P and
// sum ln Omega0) are not here: the host adds them in float64 from float64
// catalog sums (ops/cuda_lnlike.py _stream_collapsed). At 10^6 sources
// |lnL| ~ 1.5e7, where float32's spacing is ~1 and the sampler's accept
// step needs differences good to << 1. Each term is evaluated in float32,
// but the value is summed in double from the first add on (a field's grid
// integral is ~2e5 of ~200-sized cells: a float32 block sum of it is off
// by ~0.02, which lnp differences feel), and the value and the gradient
// leave in float64. The gradient columns are summed in float32 within a
// block, in double across blocks.
// The _vg kernel emits [lnl, d_cg, d_cs (= 0 here), d_aA, d_lA, d_t1, d_ac,
// d_lf50_f.., d_t2_f..], the column order of _kernel_free_stream_vg.
//
// What bounds them on the card: transcendental throughput. A source costs
// rsqrt + log (+ exp + div when fcmin is set) per walker, a grid cell one
// exp more; at 10^6 sources and W = 50 that is ~1.5e8 transcendentals per
// call against ~24.5 MB of source arrays read once (12 MB here: the
// collapse leaves logf, R and the mask).
// The TPU keeps walker blocks resident and streams (64, 128) source slabs
// past them. Here blocks run in parallel, so the design is:
//   - grid (chunks, walker tiles): the host chunk table (field, start, end,
//     is_source) cuts each field's grid cells and its (field-aligned,
//     padded) sources into pieces of <= 2048; a block reads its piece's
//     arrays once, coalesced, and loops over a tile of WT walkers whose
//     per-field features sit in shared memory, keeping WT (x slots)
//     register accumulators: each loaded source is reused WT times, so one
//     call reads the source arrays ceil(W / WT) times instead of W times
//     (free_lnlike's (chunk, walker) grid);
//   - tiles never straddle fields, so lF50_f and t2_f are per-block
//     constants (the TPU's slab_starts);
//   - the block reduces its WT x K sums (block_sum_k) into a (W, chunks, K)
//     double scratch buffer, and a second kernel sums each walker's
//     partials in double, in a fixed order (strided per thread, then a
//     fixed tree): no atomics, identical results run to run.
// Plain expf/logf/rsqrtf (no --use_fast_math), matching the plain PyTorch
// versions in ops/cuda_lnlike.py.

#include <cuda_runtime.h>

#include "common.cuh"

#define STREAM_SLOTS 6   // ops/cuda_lnlike.py VG_STREAM_SLOTS
#define WFEAT 7          // per walker: c_g, aA, lA, t1, ac, lF50_f, t2_f
// The walker tile: 4 beat 8 at every catalog size the streaming kernels
// take, for the value and the value+gradient kernel alike (PERF.md,
// H100 crossover table).
#define WT 4

// Stage the tile's walkers' features (for this block's field) in shared
// memory; rows past the last walker repeat the tile's first row, so every
// thread runs the same WT-wide loop and only the write is guarded.
__device__ __forceinline__ int stage_walkers(float (&sh)[WT][WFEAT],
                                             const float* __restrict__ feats,
                                             int nwalkers, int nfeat,
                                             int nfields, int w0, int field) {
    const int nw = min(WT, nwalkers - w0);
    if (threadIdx.x < WT) {
        const int w = w0 + (threadIdx.x < nw ? threadIdx.x : 0);
        const float* th = feats + (size_t)w * nfeat;
        float* s = sh[threadIdx.x];
        s[0] = th[0];
        s[1] = th[2];
        s[2] = th[3];
        s[3] = th[4];
        s[4] = th[5];
        s[5] = th[6 + field];
        s[6] = th[6 + nfields + field];
    }
    __syncthreads();
    return nw;
}

__global__ void __launch_bounds__(THREADS)
stream_partials(const float* __restrict__ feats, int nwalkers, int nfeat,
                int nfields,
                const float* __restrict__ g_logf, const float* __restrict__ g_a,
                const float* __restrict__ g_p, const float* __restrict__ g_r,
                const float* __restrict__ g_w,
                const float* __restrict__ s_logf,
                const float* __restrict__ s_r,
                const float* __restrict__ s_mask,
                const int4* __restrict__ chunks, int nchunks, int fcmin,
                double* __restrict__ partial) {
    __shared__ float sh[WT][WFEAT];
    const int c = blockIdx.x;
    const int w0 = blockIdx.y * WT;
    const int4 ch = chunks[c];            // (field, start, end, is_source)
    const int nw = stage_walkers(sh, feats, nwalkers, nfeat, nfields, w0,
                                     ch.x);
    double acc[WT];
#pragma unroll
    for (int j = 0; j < WT; ++j) acc[j] = 0.0;
    if (!ch.w) {
        for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS) {
            const float lf = g_logf[i], a = g_a[i], p = g_p[i], r = g_r[i];
            const float wgt = g_w[i];
#pragma unroll
            for (int j = 0; j < WT; ++j) {
                const float e = sh[j][0] + sh[j][1] * (a - sh[j][2])
                    - p * sh[j][3]
                    + ln_fc(lf, r, sh[j][4], sh[j][5], sh[j][6], fcmin);
                acc[j] -= (double)(expf(e) * wgt);
            }
        }
    } else {
        for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS) {
            if (s_mask[i] > 0.0f) {
                const float lf = s_logf[i], r = s_r[i];
#pragma unroll
                for (int j = 0; j < WT; ++j)
                    acc[j] += (double)ln_fc(lf, r, sh[j][4], sh[j][5],
                                            sh[j][6], fcmin);
            }
        }
    }
    block_sum_k<WT>(acc);
    if (threadIdx.x == 0)
        for (int j = 0; j < nw; ++j)
            partial[(size_t)(w0 + j) * nchunks + c] = acc[j];
}

// Grid chunk slots:   [Se, Se*am, Se*P, Se*dfx*dl, Se*dfx, Se*dft]
// Source tile slots:  [S lnfc, Sm*dfx*dl, Sm*dfx, Sm*dft, 0, 0]
// with am = a - lA, dl = logf - lF50_f, S over the piece's cells; slot 0
// (the value, and -d_cg) in double, the others in float.
__global__ void __launch_bounds__(THREADS)
stream_vg_partials(const float* __restrict__ feats, int nwalkers, int nfeat,
                   int nfields,
                   const float* __restrict__ g_logf,
                   const float* __restrict__ g_a,
                   const float* __restrict__ g_p,
                   const float* __restrict__ g_r,
                   const float* __restrict__ g_w,
                   const float* __restrict__ s_logf,
                   const float* __restrict__ s_r,
                   const float* __restrict__ s_mask,
                   const int4* __restrict__ chunks, int nchunks, int fcmin,
                   double* __restrict__ partial) {
    constexpr int G = STREAM_SLOTS - 1;     // float slots per walker
    __shared__ float sh[WT][WFEAT];
    const int c = blockIdx.x;
    const int w0 = blockIdx.y * WT;
    const int4 ch = chunks[c];
    const int nw = stage_walkers(sh, feats, nwalkers, nfeat, nfields, w0,
                                     ch.x);
    double val[WT];
    float acc[WT * G];
#pragma unroll
    for (int j = 0; j < WT; ++j) val[j] = 0.0;
#pragma unroll
    for (int k = 0; k < WT * G; ++k) acc[k] = 0.0f;
    if (!ch.w) {
        for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS) {
            const float lf = g_logf[i], a = g_a[i], p = g_p[i], r = g_r[i];
            const float wgt = g_w[i];
#pragma unroll
            for (int j = 0; j < WT; ++j) {
                const FcTerms t = fc_terms(lf, r, sh[j][4], sh[j][5],
                                           sh[j][6], fcmin);
                const float am = a - sh[j][2];
                const float e = expf(sh[j][0] + sh[j][1] * am - p * sh[j][3]
                                     + t.lnfc) * wgt;
                const float edfx = e * t.dfx;
                float* s = acc + j * G;
                val[j] += (double)e;
                s[0] += e * am;
                s[1] += e * p;
                s[2] += edfx * (lf - sh[j][5]);
                s[3] += edfx;
                s[4] += e * t.dft;
            }
        }
    } else {
        for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS) {
            const float m = s_mask[i];
            if (m > 0.0f) {
                const float lf = s_logf[i], r = s_r[i];
#pragma unroll
                for (int j = 0; j < WT; ++j) {
                    const FcTerms t = fc_terms(lf, r, sh[j][4], sh[j][5],
                                               sh[j][6], fcmin);
                    const float mdfx = m * t.dfx;
                    float* s = acc + j * G;
                    val[j] += (double)(m * t.lnfc);
                    s[0] += mdfx * (lf - sh[j][5]);
                    s[1] += mdfx;
                    s[2] += m * t.dft;
                }
            }
        }
    }
    block_sum_k<WT>(val);
    block_sum_k<WT * G>(acc);
    if (threadIdx.x == 0)
        for (int j = 0; j < nw; ++j) {
            double* out = partial + ((size_t)(w0 + j) * nchunks + c)
                * STREAM_SLOTS;
            out[0] = val[j];
#pragma unroll
            for (int k = 0; k < G; ++k) out[1 + k] = acc[j * G + k];
        }
}

// Sum of this thread's strided values in the block, in double, by a fixed
// tree: the result is valid in every thread.
__device__ __forceinline__ double block_sum_f64(double s, double* red) {
    __syncthreads();              // red may still be read by a last round
    red[threadIdx.x] = s;
    __syncthreads();
    for (int o = THREADS / 2; o > 0; o >>= 1) {
        if (threadIdx.x < o) red[threadIdx.x] += red[threadIdx.x + o];
        __syncthreads();
    }
    return red[0];
}

// Block w: out[w] = sum_c partial[w, c] in double.
__global__ void __launch_bounds__(THREADS)
stream_finish(const double* __restrict__ partial, int nchunks,
              double* __restrict__ out) {
    __shared__ double red[THREADS];
    const double* p = partial + (size_t)blockIdx.x * nchunks;
    double s = 0.0;
    for (int c = threadIdx.x; c < nchunks; c += THREADS) s += p[c];
    s = block_sum_f64(s, red);
    if (threadIdx.x == 0) out[blockIdx.x] = s;
}

// Block w: the walker's 1 + nfeat columns in double, one column at a time.
// Each column takes one slot of a grid chunk and one of a source tile,
// times a multiplier (0: no term), and the per-field columns only the
// pieces of their field.
__global__ void __launch_bounds__(THREADS)
stream_vg_finish(const double* __restrict__ partial,
                 const int4* __restrict__ chunks, int nchunks,
                 const float* __restrict__ feats, int nfeat, int nfields,
                 double* __restrict__ out) {
    __shared__ double red[THREADS];
    const int w = blockIdx.x;
    const int ncols = 1 + nfeat;
    const float* th = feats + (size_t)w * nfeat;
    const double aA = th[2], ac = th[5];
    const double* pw = partial + (size_t)w * nchunks * STREAM_SLOTS;
    for (int col = 0; col < ncols; ++col) {
        const int field = col < 7 ? -1 : (col - 7) % nfields;
        int gk = 0, sk = 0;
        double gm = 0.0, sm = 0.0;
        switch (col < 7 ? col : (col < 7 + nfields ? 7 : 8)) {
            case 0: gm = -1.0; sm = 1.0; break;                 // lnl
            case 1: gm = -1.0; break;                           // d_cg
            case 2: break;                                      // d_cs
            case 3: gk = 1; gm = -1.0; break;                   // d_aA
            case 4: gm = aA; break;                             // d_lA
            case 5: gk = 2; gm = 1.0; break;                    // d_t1
            case 6: gk = 3; gm = -1.0; sk = 1; sm = 1.0; break; // d_ac
            case 7: gk = 4; gm = ac; sk = 2; sm = -ac; break;   // d_lf50_f
            default: gk = 5; gm = -1.0; sk = 3; sm = 1.0;       // d_t2_f
        }
        double s = 0.0;
        for (int c = threadIdx.x; c < nchunks; c += THREADS) {
            const int4 ch = chunks[c];
            if (field >= 0 && ch.x != field) continue;
            const double m = ch.w ? sm : gm;
            if (m != 0.0)
                s += m * pw[(size_t)c * STREAM_SLOTS + (ch.w ? sk : gk)];
        }
        s = block_sum_f64(s, red);
        if (threadIdx.x == 0) out[(size_t)w * ncols + col] = s;
    }
}

extern "C" {

// All pointers are device pointers (the source arrays those of one shard);
// the stream is a cudaStream_t. Returns the cudaError_t of the launches
// (0 = success). Allocates nothing: the caller passes a (W, nchunks, K)
// double partial buffer (K = 1, or STREAM_SLOTS for the _vg kernel) and
// the double output, (W,) or (W, 1 + nfeat).
int free_stream_lnlike_launch(const float* feats, int nwalkers, int nfeat,
                              int nfields,
                              const float* g_logf, const float* g_a,
                              const float* g_p, const float* g_r,
                              const float* g_w,
                              const float* s_logf, const float* s_r,
                              const float* s_mask,
                              const int* chunks, int nchunks, int fcmin,
                              double* partial, double* out,
                              void* stream) {
    if (nfeat != 6 + 2 * nfields) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid(nchunks, (nwalkers + WT - 1) / WT);
    const int4* ch = (const int4*)chunks;
    stream_partials<<<grid, THREADS, 0, st>>>(
        feats, nwalkers, nfeat, nfields, g_logf, g_a, g_p, g_r, g_w,
        s_logf, s_r, s_mask, ch, nchunks, fcmin, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    stream_finish<<<nwalkers, THREADS, 0, st>>>(partial, nchunks, out);
    return (int)cudaGetLastError();
}

int free_stream_lnlike_vg_launch(const float* feats, int nwalkers, int nfeat,
                                 int nfields,
                                 const float* g_logf, const float* g_a,
                                 const float* g_p, const float* g_r,
                                 const float* g_w,
                                 const float* s_logf, const float* s_r,
                                 const float* s_mask,
                                 const int* chunks, int nchunks, int fcmin,
                                 double* partial, double* out,
                                 void* stream) {
    if (nfeat != 6 + 2 * nfields) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid(nchunks, (nwalkers + WT - 1) / WT);
    const int4* ch = (const int4*)chunks;
    stream_vg_partials<<<grid, THREADS, 0, st>>>(
        feats, nwalkers, nfeat, nfields, g_logf, g_a, g_p, g_r, g_w,
        s_logf, s_r, s_mask, ch, nchunks, fcmin, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    stream_vg_finish<<<nwalkers, THREADS, 0, st>>>(
        partial, ch, nchunks, feats, nfeat, nfields, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
