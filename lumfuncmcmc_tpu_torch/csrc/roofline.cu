// The same-mix roofline microbenchmark: replaces the TPU kernel
// _roofline_kernel (lumfuncmcmc_tpu/ops/pallas_roofline.py:59).
//
// One thread per element iterates the free-completeness likelihood's own
// per-element op chain (ops/roofline.py _chain: rsqrt, log, 2 exp and a
// divide, ~10 multiply-adds) `iters` times in registers, then writes the
// element once: no memory traffic in the loop, so the time per iteration
// is the card's sustained rate for exactly the mix the likelihood kernels
// execute (plain expf/logf/rsqrtf and an IEEE divide, no --use_fast_math,
// as in lnlike.cu). The loop-carried clamp keeps each iteration dependent
// on the last, so the compiler cannot hoist the chain out of the loop.
// Bound by the special-function and float32 pipelines; one wave of
// 256-thread blocks covers the 262,144 elements of the default block.

#include <cuda_runtime.h>

__device__ __forceinline__ float chain(float y) {
    const float x = 3.0f * (y - 0.41f);
    const float fc = fmaxf(0.5f + 0.5f * x * rsqrtf(1.0f + x * x), 1e-30f);
    const float lf = logf(fc);
    const float d = 1.0f - 0.999f * expf(-(y * 1.7f + 0.05f));
    const float e = -0.3f + 0.25f * y - y * 0.125f + 0.11f * (lf / d);
    const float out = expf(e);
    return fminf(fmaxf(0.9f * out, 0.05f), 0.95f);
}

__global__ void __launch_bounds__(256)
roofline_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int n, int iters) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float y = x[i];
    for (int k = 0; k < iters; ++k) y = chain(y);
    out[i] = y;
}

extern "C" {

// x and out are device pointers to n floats; the stream is a cudaStream_t.
// Returns the cudaError_t of the launch (0 = success).
int roofline_chain_launch(const float* x, float* out, int n, int iters,
                          void* stream) {
    if (n <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
    roofline_chain_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        x, out, n, iters);
    return (int)cudaGetLastError();
}

}  // extern "C"
