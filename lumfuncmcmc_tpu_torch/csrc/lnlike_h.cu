// Hierarchical multi-field log-likelihood kernels for Hopper (sm_90a): the
// value kernel and its value + feature-gradient twin (the NUTS gradient path
// of the hierarchical model). A third source of the one kernel library:
// ops/_build.py compiles it together with lnlike.cu and lnlike_z.cu, with
// which it shares common.cuh.
//
// hier_lnlike replaces the TPU kernels _kernel_hier_bcast
// (lumfuncmcmc_tpu/ops/pallas_lnlike.py:713) and _kernel_hier_slab (:734):
// two VMEM layouts of one function there, one kernel here. hier_lnlike_vg
// replaces _kernel_hier_vg (:1221).
//
// What they compute, per walker w (feature row th = feats[w], 1 + 3F floats,
// see _feat_h_one in ops/cuda_lnlike.py: [aA, (c_f, lA_f, t1_f) x F]):
//   lnl = - sum_f sum_{cells of field f} exp(c_f + aA (a - lA_f)
//                                            - P t1_f) * w
// the fixed-completeness integral with every field at its own (L*, phi*);
// lnrest (the per-field collapsed ln-terms plus the Gaussian population
// hyperprior) is added on the host, in float64, from the same rounded
// features (ops/cuda_lnlike.py _hier_collapsed). a = LN10 (logL - lref)
// and P = 10^(logL - lref) are precomputed on the host, so a cell costs one
// exp. Each thread sums its few cells in float32; the block reduction, the
// partials and the value are double.
// hier_lnlike_vg emits [lnl, d_aA, (d_c_f, d_lA_f, d_t1_f) x F]
// from three sums per field, s0 = sum e, s1 = sum e (a - lA_f), s2 = sum e P:
//   d_aA = -sum_f s1_f,  d_c_f = -s0_f,  d_lA_f = aA s0_f,  d_t1_f = s2_f.
//
// What bounds them on the card: as fixed_lnlike (lnlike.cu), whose cells
// these are. At the fit's shape (5 fields x 201 x 201 cells, W = 50 walkers
// per stretch half-step, W = 8 NUTS chains) a call is 1.6-10 M cell
// evaluations of 8-12 float32 operations over 2.4 MB of grid arrays that
// stay in L2 across walkers: launch latency and the dependent exp chain per
// thread bound it, not bytes. The design is fixed_lnlike's:
//   - grid (nchunks, W): block (c, w) reduces chunk c of the host table
//     (field, start, end, is_source), at most 2048 cells of ONE field, for
//     walker w, and reads that field's (c_f, lA_f, t1_f) from the feature
//     row: the per-field lookup costs three loads per block;
//   - each thread keeps K sums in registers (K = 1, or 3 for _vg), the block
//     reduces them with warp shuffles and writes them to a (W, nchunks, K)
//     scratch buffer; a second small kernel sums each walker's partials in
//     fixed chunk order in double (per field for _vg, from tiles staged in
//     shared memory): no float atomics, identical results run to run.
// Plain expf (no --use_fast_math), matching the plain PyTorch versions in
// ops/cuda_lnlike.py.

#include <cuda_runtime.h>

#include "common.cuh"

#define HIER_SLOTS 3          // ops/cuda_lnlike.py VG_HIER_SLOTS
#define MAX_HIER_FIELDS 64    // ops/cuda_lnlike.py MAX_HIER_FIELDS

__global__ void __launch_bounds__(THREADS)
hier_partials(const float* __restrict__ feats, int nfeat,
              const float* __restrict__ g_a, const float* __restrict__ g_p,
              const float* __restrict__ g_w,
              const int4* __restrict__ chunks, int nchunks,
              double* __restrict__ partial) {
    const int c = blockIdx.x;
    const int w = blockIdx.y;
    const int4 ch = chunks[c];            // (field, start, end, is_source)
    const float* th = feats + (size_t)w * nfeat;
    const float* tf = th + 1 + 3 * ch.x;
    const float aA = th[0], cg = tf[0], lA = tf[1], t1 = tf[2];
    float acc[1] = {0.0f};
    for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS)
        acc[0] -= expf(cg + aA * (g_a[i] - lA) - g_p[i] * t1) * g_w[i];
    const double s = block_sum_f32_to_f64(acc[0]);
    if (threadIdx.x == 0) partial[(size_t)w * nchunks + c] = s;
}

// Slots: [Se, Se*am, Se*P] with am = a - lA_f of the chunk's field.
__global__ void __launch_bounds__(THREADS)
hier_vg_partials(const float* __restrict__ feats, int nfeat,
                 const float* __restrict__ g_a,
                 const float* __restrict__ g_p,
                 const float* __restrict__ g_w,
                 const int4* __restrict__ chunks, int nchunks,
                 double* __restrict__ partial) {
    const int c = blockIdx.x;
    const int w = blockIdx.y;
    const int4 ch = chunks[c];
    const float* th = feats + (size_t)w * nfeat;
    const float* tf = th + 1 + 3 * ch.x;
    const float aA = th[0], cg = tf[0], lA = tf[1], t1 = tf[2];
    float acc[HIER_SLOTS] = {0.0f, 0.0f, 0.0f};
    for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS) {
        const float am = g_a[i] - lA;
        const float p = g_p[i];
        const float e = expf(cg + aA * am - p * t1) * g_w[i];
        acc[0] += e;
        acc[1] += e * am;
        acc[2] += e * p;
    }
    double sums[HIER_SLOTS] = {acc[0], acc[1], acc[2]};
    block_sum_k<HIER_SLOTS>(sums);
    if (threadIdx.x == 0) {
        double* out = partial + ((size_t)w * nchunks + c) * HIER_SLOTS;
#pragma unroll
        for (int k = 0; k < HIER_SLOTS; ++k) out[k] = sums[k];
    }
}

// Block w. Thread t < 3F owns (field f = t / 3, slot k = t % 3) and sums
// that slot over the field's chunks in order, in double, from tiles of the
// walker's partials and of the chunk table staged in shared memory with
// coalesced loads; every thread walks every staged chunk and adds under a
// predicate, so the warp does not diverge. Then thread t writes its own
// column (-s0_f, aA s0_f or s2_f) and thread 0 the two leading ones, the
// fields added in order.
__global__ void hier_vg_finish(const double* __restrict__ partial,
                               const int4* __restrict__ chunks, int nchunks,
                               const float* __restrict__ feats, int nfeat,
                               int nfields, double* __restrict__ out) {
    __shared__ double tile[FINISH_TILE * HIER_SLOTS];
    __shared__ int tile_field[FINISH_TILE];
    __shared__ double sums[MAX_HIER_FIELDS * HIER_SLOTS];
    const int w = blockIdx.x;
    const int t = threadIdx.x;
    const int f = t / HIER_SLOTS;
    const int k = t - f * HIER_SLOTS;
    const bool owner = t < nfields * HIER_SLOTS;
    const double* pw = partial + (size_t)w * nchunks * HIER_SLOTS;
    double s = 0.0;
    for (int c0 = 0; c0 < nchunks; c0 += FINISH_TILE) {
        const int n = min(FINISH_TILE, nchunks - c0);
        __syncthreads();
        for (int i = t; i < n * HIER_SLOTS; i += blockDim.x)
            tile[i] = pw[(size_t)c0 * HIER_SLOTS + i];
        for (int i = t; i < n; i += blockDim.x)
            tile_field[i] = chunks[c0 + i].x;
        __syncthreads();
        if (owner)
            for (int c = 0; c < n; ++c)
                s += tile_field[c] == f ? tile[c * HIER_SLOTS + k] : 0.0;
    }
    if (owner) sums[t] = s;
    __syncthreads();
    const float* th = feats + (size_t)w * nfeat;
    const int ncols = 2 + 3 * nfields;
    double* o = out + (size_t)w * ncols;
    if (owner) {
        const double aA = (double)th[0];
        const double s0 = sums[f * HIER_SLOTS];
        o[2 + t] = k == 0 ? -s0 : (k == 1 ? aA * s0 : s);
    }
    if (t == 0) {
        double lnl = 0.0, d_aA = 0.0;
        for (int g = 0; g < nfields; ++g) {
            lnl -= sums[g * HIER_SLOTS];
            d_aA -= sums[g * HIER_SLOTS + 1];
        }
        o[0] = lnl;
        o[1] = d_aA;
    }
}

extern "C" {

// All pointers are device pointers; the stream is a cudaStream_t. Returns
// the cudaError_t of the launches (0 = success). Allocates nothing: the
// caller passes a (W, nchunks, K) double partial buffer (K = 1, or
// HIER_SLOTS for _vg) and the double output, (W,) or (W, 2 + 3 nfields).
int hier_lnlike_launch(const float* feats, int nwalkers, int nfeat,
                       int nfields,
                       const float* g_a, const float* g_p, const float* g_w,
                       const int* chunks, int nchunks,
                       double* partial, double* out, void* stream) {
    if (nfeat != 1 + 3 * nfields) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid(nchunks, nwalkers);
    hier_partials<<<grid, THREADS, 0, st>>>(
        feats, nfeat, g_a, g_p, g_w, (const int4*)chunks, nchunks, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    finish<<<(nwalkers + 127) / 128, 128, 0, st>>>(partial, nchunks,
                                                   nwalkers, out);
    return (int)cudaGetLastError();
}

int hier_lnlike_vg_launch(const float* feats, int nwalkers, int nfeat,
                          int nfields,
                          const float* g_a, const float* g_p,
                          const float* g_w,
                          const int* chunks, int nchunks,
                          double* partial, double* out, void* stream) {
    if (nfeat != 1 + 3 * nfields || nfields < 1 ||
        nfields > MAX_HIER_FIELDS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid(nchunks, nwalkers);
    hier_vg_partials<<<grid, THREADS, 0, st>>>(
        feats, nfeat, g_a, g_p, g_w, (const int4*)chunks, nchunks, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int threads = (nfields * HIER_SLOTS + 31) / 32 * 32;
    hier_vg_finish<<<nwalkers, threads, 0, st>>>(
        partial, (const int4*)chunks, nchunks, feats, nfeat, nfields, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
