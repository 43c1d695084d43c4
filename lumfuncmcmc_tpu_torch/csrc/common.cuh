// What the kernel sources of this directory share: the block size, the
// block reduction, the value kernels' finish pass and the free-completeness
// ln fc terms (lnlike.cu and lnlike_stream.cu). Each .cu file is its
// own translation unit of the one library (ops/_build.py), so the finish
// kernel is static.

#pragma once

#include <cuda_runtime.h>

#define THREADS 256
#define FINISH_TILE 256  // chunks a _vg finish kernel stages at a time

// ln Fleming completeness of one cell or source, x = ac (logf - lF50):
// ln max(0.5 + 0.5 x rsqrt(1 + x^2), 1e-30), over 1 - exp(-R t2) when fcmin
// is set.
__device__ __forceinline__ float ln_fc(float logf_, float r, float ac,
                                       float lf50, float t2, int fcmin) {
    const float x = ac * (logf_ - lf50);
    const float fc = fmaxf(0.5f + 0.5f * x * rsqrtf(1.0f + x * x), 1e-30f);
    const float lf = logf(fc);
    if (!fcmin) return lf;
    return lf / (1.0f - expf(-(r * t2)));
}

// The same with its derivatives, for the value + gradient kernels.
struct FcTerms {
    float lnfc;   // ln fc (over 1 - exp(-R t2) when fcmin is set)
    float dfx;    // d lnfc / dx, x = ac (logf - lF50)
    float dft;    // d lnfc / d t2
};

__device__ __forceinline__ FcTerms fc_terms(float logf_, float r, float ac,
                                            float lf50, float t2,
                                            int fcmin) {
    const float x = ac * (logf_ - lf50);
    const float u = rsqrtf(1.0f + x * x);
    const float fc = fmaxf(0.5f + 0.5f * x * u, 1e-30f);
    const float lfc = logf(fc);
    const float dfx = 0.5f * u * u * u / fc;
    if (!fcmin) return {lfc, dfx, 0.0f};
    const float q = expf(-(r * t2));
    const float inv_d = 1.0f / (1.0f - q);
    return {lfc * inv_d, dfx * inv_d, -lfc * (r * q) * inv_d * inv_d};
}

// Sum each of v[0..K) over the block (float or double); the results are
// valid in thread 0.
template <int K, typename T>
__device__ __forceinline__ void block_sum_k(T (&v)[K]) {
    __shared__ T red[K][THREADS / 32];
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        T x = v[k];
        for (int o = 16; o > 0; o >>= 1)
            x += __shfl_down_sync(0xffffffffu, x, o);
        if (lane == 0) red[k][wid] = x;
    }
    __syncthreads();
    if (wid == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            T x = (lane < THREADS / 32) ? red[k][lane] : T(0);
            for (int o = 16; o > 0; o >>= 1)
                x += __shfl_down_sync(0xffffffffu, x, o);
            v[k] = x;
        }
    }
}

// out[w] = (base_col >= 0 ? feats[w, base_col] : 0) + sum_c partial[w, c],
// summed in chunk order, in double.
static __global__ void finish(const float* __restrict__ partial, int nchunks,
                              const float* __restrict__ feats, int nfeat,
                              int base_col, int nwalkers,
                              float* __restrict__ out) {
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= nwalkers) return;
    double s = base_col >= 0 ? (double)feats[(size_t)w * nfeat + base_col]
                             : 0.0;
    const float* p = partial + (size_t)w * nchunks;
    for (int c = 0; c < nchunks; ++c) s += (double)p[c];
    out[w] = (float)s;
}
