// The same-mix roofline microbenchmark: replaces the TPU kernel
// _roofline_kernel (lumfuncmcmc_tpu/ops/pallas_roofline.py:59).
//
// Each element iterates the free-completeness value kernel's own
// per-element op chain (ops/roofline.py _chain: rsqrt, log, 2 exp and a
// divide, ~10 multiply-adds) `iters` times in registers and is written
// once: no memory traffic in the loop, so the time per iteration is the
// card's sustained rate for exactly the mix free_lnlike executes. That mix
// is ln_fc_sfu's (lnlike.cu) plus the integrand's exp: rsqrtf and __logf
// (common.cuh ln_fleming_sfu, shared with it), expf for the decay,
// __fdividef, expf for the integrand; no accurate logf, no IEEE divide, no
// --use_fast_math (expf stays the libdevice sequence around one ex2). The
// loop-carried clamp keeps each iteration dependent on the last, so the
// compiler cannot hoist the chain out of the loop.
//
// What bounds it: issue. The loop executes 47.5 SASS instructions a chain
// and iteration (31 FP32, 5 MUFU, 8.5 ALU, 3 other; the accurate logf and
// the IEEE divide took it to 77.5), so (256, 1024) x 512 needs 190.57 us
// of issue at 1,980 MHz and 160.48 us of the special-function unit (16
// results a clock an SM); the kernel takes ~237 us (tools/roofline_sass.py,
// PERF.md, NVIDIA H100 80GB HBM3 at 700 W). Each thread iterates
// ROOFLINE_CHAINS (E) independent elements, their chains interleaved in one
// loop, so that one element's MUFU wait overlaps another's FMAs. E = 1, 2
// and 4 ran within 0.3% of each other there: at this size the warps hide
// the latency too. E = 2 holds 25 registers, 8 blocks resident an SM.
//
// Layout: a block of 256 threads takes a group of 256 E consecutive
// elements, element g 256 E + e 256 + t to thread t (coalesced for every
// e; out-of-range elements iterate a dummy and are not written, so any
// n >= 1 runs). The grid is min(groups, SMs x resident blocks an SM), a
// grid-stride loop over groups beyond one wave. At E = 2 and the default
// (256, 1024) block: 512 groups, one wave over 132 SMs, 4 blocks on most
// SMs and 3 on the rest: the busiest SMs hold 2,048 elements (32 warps x
// 2 chains) against a mean of 1,985.9, 3.1% over. No layout with whole
// warps of E >= 2 chains does better: 4,096 such warps over 132 SMs are
// 31.03 an SM, so 32 on the busiest.

#include <cuda_runtime.h>

#include "common.cuh"

#ifndef ROOFLINE_CHAINS
#define ROOFLINE_CHAINS 2
#endif

#define GROUP (THREADS * ROOFLINE_CHAINS)    // elements a block a pass

// One application of ops/roofline.py _chain, its operations in its order.
__device__ __forceinline__ float chain(float y) {
    const float lf = ln_fleming_sfu(3.0f * (y - 0.41f));
    const float d = 1.0f - 0.999f * expf(-(y * 1.7f + 0.05f));
    const float e =
        -0.3f + 0.25f * y - y * 0.125f + 0.11f * __fdividef(lf, d);
    return fminf(fmaxf(0.9f * expf(e), 0.05f), 0.95f);
}

__host__ __device__ inline long long groups_of(int n) {
    return ((long long)n + GROUP - 1) / GROUP;
}

__global__ void __launch_bounds__(THREADS)
roofline_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int n, int iters) {
    constexpr int E = ROOFLINE_CHAINS;
    for (long long g = blockIdx.x; g < groups_of(n); g += gridDim.x) {
        const long long base = g * GROUP + threadIdx.x;
        float y[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const long long i = base + e * THREADS;
            y[e] = i < n ? x[i] : 0.5f;
        }
        for (int k = 0; k < iters; ++k) {
#pragma unroll
            for (int e = 0; e < E; ++e) y[e] = chain(y[e]);
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const long long i = base + e * THREADS;
            if (i < n) out[i] = y[e];
        }
    }
}

// The grid for n elements: min(groups, SMs x resident blocks an SM) on the
// current device, the two counts queried once a device.
static int roofline_grid(int n, int* blocks, int* nsm, int* per_sm) {
    static int cache[64][2];
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return (int)rc;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (cache[dev][0] == 0) {
        int sms = 0, occ = 0;
        rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
        if (rc != cudaSuccess) return (int)rc;
        rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, roofline_chain_kernel, THREADS, 0);
        if (rc != cudaSuccess) return (int)rc;
        cache[dev][1] = occ;
        cache[dev][0] = sms;
    }
    *nsm = cache[dev][0];
    *per_sm = cache[dev][1];
    const long long groups = groups_of(n);
    const long long wave = (long long)*nsm * *per_sm;
    *blocks = (int)(groups < wave ? groups : wave);
    return 0;
}

extern "C" {

// x and out are device pointers to n floats; the stream is a cudaStream_t.
// Returns the cudaError_t of the launch (0 = success).
int roofline_chain_launch(const float* x, float* out, int n, int iters,
                          void* stream) {
    if (n <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
    int blocks, nsm, per_sm;
    const int rc = roofline_grid(n, &blocks, &nsm, &per_sm);
    if (rc != 0) return rc;
    roofline_chain_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        x, out, n, iters);
    return (int)cudaGetLastError();
}

// The launch's layout for n elements on the current device, into out[7]:
// chains a thread (E), blocks, threads a block, registers a thread,
// resident blocks an SM, SMs, local (spill) bytes a thread.
int roofline_chain_layout(int n, int* out) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    int blocks, nsm, per_sm;
    const int rc = roofline_grid(n, &blocks, &nsm, &per_sm);
    if (rc != 0) return rc;
    cudaFuncAttributes attr;
    const cudaError_t err =
        cudaFuncGetAttributes(&attr, roofline_chain_kernel);
    if (err != cudaSuccess) return (int)err;
    out[0] = ROOFLINE_CHAINS;
    out[1] = blocks;
    out[2] = THREADS;
    out[3] = attr.numRegs;
    out[4] = per_sm;
    out[5] = nsm;
    out[6] = (int)attr.localSizeBytes;
    return 0;
}

}  // extern "C"
