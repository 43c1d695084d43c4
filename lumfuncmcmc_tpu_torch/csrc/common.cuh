// What the kernel sources of this directory share: the block size, the
// block reduction and the value kernels' finish pass. Each .cu file is its
// own translation unit of the one library (ops/_build.py), so the finish
// kernel is static.

#pragma once

#include <cuda_runtime.h>

#define THREADS 256
#define FINISH_TILE 256  // chunks a _vg finish kernel stages at a time

// Sum each of v[0..K) over the block; the results are valid in thread 0.
template <int K>
__device__ __forceinline__ void block_sum_k(float (&v)[K]) {
    __shared__ float red[K][THREADS / 32];
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        float x = v[k];
        for (int o = 16; o > 0; o >>= 1)
            x += __shfl_down_sync(0xffffffffu, x, o);
        if (lane == 0) red[k][wid] = x;
    }
    __syncthreads();
    if (wid == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            float x = (lane < THREADS / 32) ? red[k][lane] : 0.0f;
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
