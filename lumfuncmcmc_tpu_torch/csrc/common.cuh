// What the kernel sources of this directory share: the block size, the
// block reduction of the streaming kernels (lnlike_stream.cu), Kahan's
// float32 sum (lnlike_z.cu, lnlike_stream.cu), the free-completeness
// ln fc terms (lnlike.cu and lnlike_stream.cu) and the SFU log of ln fc
// (lnlike.cu and roofline.cu). The one-launch kernels' block sums,
// tickets and finish are in vg_ticket.cuh.
//
// Every value leaves the kernels in float64: at 10^5 sources |lnL| ~ 1e6,
// where float32's spacing (~0.06) is past the 0.05 that the sampler's
// accept step can bear in the lnp difference of two close thetas. Each
// thread sums its few terms in float32; the block reduction, the
// partials and the finish are double.

#pragma once

#include <cuda_runtime.h>

#define THREADS 256

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

// ln max(0.5 + 0.5 x rsqrt(1 + x^2), 1e-30) with the SFU's log: __logf is
// within 2^-21.4 of ln fc for fc in [0.5, 1] and 3 ulp below. The rsqrt and
// log of the value kernel's ln fc (lnlike.cu ln_fc_sfu) and of the roofline's
// chain (roofline.cu chain), one definition so that the yardstick runs the
// value kernel's mix. The divide that follows stays in each, since the
// divisors differ (1 - exp(-R t2) in ln_fc_sfu, 1 - 0.999 exp(-(1.7 y +
// 0.05)) in chain): both take __fdividef.
__device__ __forceinline__ float ln_fleming_sfu(float x) {
    return __logf(fmaxf(0.5f + 0.5f * x * rsqrtf(1.0f + x * x), 1e-30f));
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

// s is a running float32 sum and c Kahan's compensation (minus the low
// part s lost): the sum is s - c, to be taken in double.
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
    const float y = x - c;
    const float t = s + y;
    c = (t - s) - y;
    s = t;
}
