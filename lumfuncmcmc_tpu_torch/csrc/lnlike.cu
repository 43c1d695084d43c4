// Single-epoch log-likelihood kernels for Hopper (sm_90a).
//
// free_lnlike replaces the TPU kernels _kernel_free_bcast
// (lumfuncmcmc_tpu/ops/pallas_lnlike.py:601) and _kernel_free (:761);
// fixed_lnlike replaces _kernel_fixed_bcast (:751) and _kernel_fixed
// (:813). The TPU's broadcast/slab variants are two VMEM layouts of one
// computation; here one layout serves every catalog size.
//
// What they compute, per walker w (feature row th = feats[w]):
//   free:  sum over fields f of
//            - sum_cells  exp(c_g + aA (a - lA) - P t1 + ln fc) * w
//            + sum_src    mask ? (c_s + aA (a - lA) - P t1 + lnOm0 + ln fc) : 0
//          ln fc = ln max(0.5 + 0.5 x rsqrt(1 + x^2), 1e-30), x = ac (logf - lF50_f),
//          divided by (1 - exp(-R t2_f)) when fcmin is set.
//   fixed: th[4] - sum_cells exp(c + aA (a - lA) - P t1) * w
// P = 10^(logL - lref) and R = 10^(logf + 16) are precomputed on the
// host, so the per-element work is 2 exp + 1 log + 1 rsqrt + 1 div (free)
// or 1 exp (fixed).
//
// What bounds them on the card: transcendental throughput and launch
// latency. At the flagship shape (W = 50 walkers x 51,005 cells) one call
// is ~2.6 M cell evaluations: a few microseconds of SFU work, with the
// grid arrays (1 MB) resident in L2 across walkers. The design keeps the
// SMs busy at small W and stays deterministic:
//   - grid (nchunks, W): block (c, w) reduces chunk c (<= 2048 cells or
//     sources of one field, from the host chunk table) for walker w, so
//     W = 50 already gives ~1,500 blocks for 132 SMs;
//   - each thread accumulates in registers, the block reduces with warp
//     shuffles and shared memory, and writes one partial to a (W, nchunks)
//     scratch buffer the caller allocates;
//   - a second small kernel sums each walker's partials in fixed chunk
//     order (in double): no float atomics, identical results run to run.
// Plain expf/logf/rsqrtf (no --use_fast_math), matching the plain PyTorch
// version in ops/cuda_lnlike.py.

#include <cuda_runtime.h>

#define THREADS 256

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// Sum over the block; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
    __shared__ float red[THREADS / 32];
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    v = warp_sum(v);
    if (lane == 0) red[wid] = v;
    __syncthreads();
    v = (threadIdx.x < THREADS / 32) ? red[threadIdx.x] : 0.0f;
    if (wid == 0) v = warp_sum(v);
    return v;
}

__device__ __forceinline__ float ln_fc(float logf_, float r, float ac,
                                       float lf50, float t2, int fcmin) {
    const float x = ac * (logf_ - lf50);
    const float fc = fmaxf(0.5f + 0.5f * x * rsqrtf(1.0f + x * x), 1e-30f);
    const float lf = logf(fc);
    if (!fcmin) return lf;
    return lf / (1.0f - expf(-(r * t2)));
}

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
              float* __restrict__ partial) {
    const int c = blockIdx.x;
    const int w = blockIdx.y;
    const int4 ch = chunks[c];            // (field, start, end, is_source)
    const float* th = feats + (size_t)w * nfeat;
    const float aA = th[2], lA = th[3], t1 = th[4], ac = th[5];
    const float lf50 = th[6 + ch.x];
    const float t2 = th[6 + nfields + ch.x];
    float acc = 0.0f;
    if (!ch.w) {
        const float c_g = th[0];
        for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS) {
            const float e = c_g + aA * (g_a[i] - lA) - g_p[i] * t1
                + ln_fc(g_logf[i], g_r[i], ac, lf50, t2, fcmin);
            acc -= expf(e) * g_w[i];
        }
    } else {
        const float c_s = th[1];
        for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS) {
            if (s_mask[i] > 0.0f) {
                acc += c_s + aA * (s_a[i] - lA) - s_p[i] * t1 + s_lnom0[i]
                    + ln_fc(s_logf[i], s_r[i], ac, lf50, t2, fcmin);
            }
        }
    }
    const float s = block_sum(acc);
    if (threadIdx.x == 0) partial[(size_t)w * nchunks + c] = s;
}

__global__ void __launch_bounds__(THREADS)
fixed_partials(const float* __restrict__ feats, int nfeat,
               const float* __restrict__ g_a, const float* __restrict__ g_p,
               const float* __restrict__ g_w,
               const int4* __restrict__ chunks, int nchunks,
               float* __restrict__ partial) {
    const int c = blockIdx.x;
    const int w = blockIdx.y;
    const int4 ch = chunks[c];
    const float* th = feats + (size_t)w * nfeat;
    const float cg = th[0], aA = th[1], lA = th[2], t1 = th[3];
    float acc = 0.0f;
    for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS)
        acc -= expf(cg + aA * (g_a[i] - lA) - g_p[i] * t1) * g_w[i];
    const float s = block_sum(acc);
    if (threadIdx.x == 0) partial[(size_t)w * nchunks + c] = s;
}

// out[w] = (base_col >= 0 ? feats[w, base_col] : 0) + sum_c partial[w, c],
// summed in chunk order.
__global__ void finish(const float* __restrict__ partial, int nchunks,
                       const float* __restrict__ feats, int nfeat,
                       int base_col, int nwalkers, float* __restrict__ out) {
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= nwalkers) return;
    double s = base_col >= 0 ? (double)feats[(size_t)w * nfeat + base_col]
                             : 0.0;
    const float* p = partial + (size_t)w * nchunks;
    for (int c = 0; c < nchunks; ++c) s += (double)p[c];
    out[w] = (float)s;
}

extern "C" {

// All pointers are device pointers; the stream is a cudaStream_t. Returns
// the cudaError_t of the launches (0 = success). Allocates nothing.
int free_lnlike_launch(const float* feats, int nwalkers, int nfeat,
                       int nfields,
                       const float* g_logf, const float* g_a,
                       const float* g_p, const float* g_r, const float* g_w,
                       const float* s_logf, const float* s_a,
                       const float* s_p, const float* s_r,
                       const float* s_lnom0, const float* s_mask,
                       const int* chunks, int nchunks, int fcmin,
                       float* partial, float* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid(nchunks, nwalkers);
    free_partials<<<grid, THREADS, 0, st>>>(
        feats, nfeat, nfields, g_logf, g_a, g_p, g_r, g_w, s_logf, s_a, s_p,
        s_r, s_lnom0, s_mask, (const int4*)chunks, nchunks, fcmin, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    finish<<<(nwalkers + 127) / 128, 128, 0, st>>>(
        partial, nchunks, feats, nfeat, -1, nwalkers, out);
    return (int)cudaGetLastError();
}

int fixed_lnlike_launch(const float* feats, int nwalkers, int nfeat,
                        const float* g_a, const float* g_p, const float* g_w,
                        const int* chunks, int nchunks,
                        float* partial, float* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid(nchunks, nwalkers);
    fixed_partials<<<grid, THREADS, 0, st>>>(
        feats, nfeat, g_a, g_p, g_w, (const int4*)chunks, nchunks, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    finish<<<(nwalkers + 127) / 128, 128, 0, st>>>(
        partial, nchunks, feats, nfeat, 4, nwalkers, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
