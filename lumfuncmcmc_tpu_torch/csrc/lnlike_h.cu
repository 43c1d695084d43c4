// Fixed-completeness log-likelihood kernels for Hopper (sm_90a), one kernel
// body: the hierarchical multi-field value kernel (the stretch path of
// `fith`) and its value + feature-gradient twin (its NUTS gradient path),
// and the same pair with the features shared by every field, the
// single-epoch fixed-completeness kernels (the stretch and NUTS paths of
// `fit -fc`). A third source of the one kernel library: ops/_build.py
// compiles it together with lnlike.cu and lnlike_z.cu, with which it
// shares common.cuh.
//
// hier_lnlike replaces the TPU kernels _kernel_hier_bcast
// (lumfuncmcmc_tpu/ops/pallas_lnlike.py:713) and _kernel_hier_slab (:734):
// two VMEM layouts of one function there, one kernel here. hier_lnlike_vg
// replaces _kernel_hier_vg (:1221). fixed_lnlike replaces
// _kernel_fixed_bcast (:751) and _kernel_fixed (:813), fixed_lnlike_vg
// _kernel_fixed_vg (:1255): their cells are these cells.
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
// fixed_lnlike (feature row [c, aA, lA, t1], the same for every field)
// emits lnl = -S0, fixed_lnlike_vg [lnl, d_c, d_aA, d_lA, d_t1] = [-S0,
// -S0, -S1, aA S0, S2], from the same sums S0, S1, S2 over every field's
// cells (the collapsed source term is added on the host:
// ops/cuda_lnlike.py _fixed_collapsed).
//
// What bounds them on the card: at the fits' shape (5 fields x 201 x 201
// cells, W = 50 walkers per stretch half-step, W = 8 NUTS chains) a call
// is 1.6-10 M cell evaluations of 8-12 float32 operations over 2.4 MB of
// grid arrays that stay in L2 across walkers: launch latency and the
// dependent exp chain per thread bound it, not bytes. All four were first
// built in two passes: a (nchunks, W) grid, block (c, w) reducing chunk c
// of a host table (at most 2048 cells of one field) for one walker into a
// (W, nchunks) scratch buffer, then a small kernel summing each walker's
// partials in chunk order. The finish pass of hier_lnlike_vg alone took
// 5.6-6.1 us a call whatever W, more than its partial pass at W = 1 and 8,
// and at W = 256 the partial pass took 81 us, 2.3x the same-mix bound,
// each block reading its chunk from L2 once per walker; hier_lnlike and
// fixed_lnlike took 23.3 us at W = 50 so (PERF.md, H100 80GB HBM3). All
// four are now one launch a call of one kernel body, the same rows, as
// free_lnlike(_vg) (lnlike.cu):
//   - a (piece, walker tile) grid, the piece length and tile picked on the
//     host from W and the SM count (ops/cuda_lnlike.py _vg_geometry, each
//     kernel its own tiles, VG_TILES): the value kernels, one sum a walker,
//     take tiles of up to 8 walkers; the value+gradient kernels, three
//     sums a walker, 1, 2 or 4 (tiles of 8 held 76 registers, 3 blocks an
//     SM, and ran slower). At W = 8 tiles of 2 walkers on pieces of ~4040
//     cells (200 blocks; fixed_lnlike_vg, whose sweep preferred the larger
//     tile, tiles of 4 on ~2020), at W = 256 tiles of 4 (3200 blocks), so a
//     cell is read once per tile and a thread runs up to T independent exp
//     chains;
//   - each thread loads its next cell before it computes this one;
//   - the block reduces its T x S sums by a reduce-scatter over the lanes
//     (vg_ticket.cuh vg_block_sums), writes its double partials and draws
//     its tile's ticket; the tile's last block sums the partials per field
//     in a fixed order and writes the rows (vg_ticket.cuh): no finish
//     kernel, no float atomics, the same bits run to run.
// Plain expf (no --use_fast_math), matching the plain PyTorch versions in
// ops/cuda_lnlike.py.

#include <cuda_runtime.h>

#include "common.cuh"
#include "vg_ticket.cuh"

#define HIER_SLOTS 3          // ops/cuda_lnlike.py VG_HIER_SLOTS
#define MAX_HIER_FIELDS 64    // ops/cuda_lnlike.py MAX_HIER_FIELDS

// hier_lnlike (S 1) and hier_lnlike_vg (S HIER_SLOTS), SHARED false;
// fixed_lnlike (S 1) and fixed_lnlike_vg (S HIER_SLOTS), SHARED true: one
// kernel per call, as free_lnlike(_vg) (lnlike.cu). Block (p, t) runs
// piece p (cells of one field f) for the T walkers of tile t: each thread
// takes one cell a loop trip, the next trip's loaded before this one's is
// computed, against every walker of the tile from registers. The features
// (c, lA, t1) are field f's, at 1 + 3 f in the hierarchical row, or the
// row's own, at 0, 2 and 3, for every field (aA at 0, or 1). Slots, per
// walker: [Se] (S 1) or [Se, Se*am, Se*P] with am = a - lA; float32 per
// thread, the block's reduction and the (W, npieces, S) partials double.
// The tile's last block to draw its ticket sums them per segment (one
// field's pieces) in a fixed order and writes lnl = -sum_f s0_f (S 1), or
// [lnl, d_aA, (d_c_f, d_lA_f, d_t1_f) x F] = [-sum_f s0_f, -sum_f s1_f,
// (-s0_f, aA s0_f, s2_f) x F], or (SHARED) [lnl, d_c, d_aA, d_lA, d_t1] =
// [-S0, -S0, -S1, aA S0, S2] with S the sums over every segment, the
// segments added in order.
template <int T, bool SHARED, int S>
__global__ void __launch_bounds__(THREADS)
hier_vg(const float* __restrict__ feats, int nwalkers, int nfeat,
        int nfields,
        const float* __restrict__ g_a, const float* __restrict__ g_p,
        const float* __restrict__ g_w,
        const int4* __restrict__ pieces, const int4* __restrict__ segs,
        int nseg, double* __restrict__ partial, int* __restrict__ tickets,
        double* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];   // vg_smem
    int4* seg_sh = (int4*)smem;         // the segment table, for the finish
    double* segsum = (double*)(smem + (size_t)nseg * sizeof(int4));
    for (int s = threadIdx.x; s < nseg; s += THREADS) seg_sh[s] = segs[s];
    const int4 pc = pieces[blockIdx.x];     // (field, start, end, 0)
    const int w0 = blockIdx.y * T;
    const int nw = min(T, nwalkers - w0);
    // the tile's features for the piece's field; rows past the last walker
    // repeat the first, so only the writes are guarded
    float aA[T], cg[T], lA[T], t1[T];
    __shared__ float fin[T];            // aA, for the finish
#pragma unroll
    for (int j = 0; j < T; ++j) {
        const float* th = feats + (size_t)(w0 + (j < nw ? j : 0)) * nfeat;
        const float* tf = SHARED ? th : th + 1 + 3 * pc.x;
        aA[j] = th[SHARED ? 1 : 0];
        cg[j] = tf[0];
        lA[j] = tf[SHARED ? 2 : 1];
        t1[j] = tf[SHARED ? 3 : 2];
        if (threadIdx.x == 0) fin[j] = aA[j];
    }
    float acc[T * S];
#pragma unroll
    for (int k = 0; k < T * S; ++k) acc[k] = 0.0f;
    // the last trip's prefetch re-reads the piece's last cell
    int i = pc.y + threadIdx.x;
    int nx = min(i, pc.z - 1);
    float a = g_a[nx], p = g_p[nx], wg = g_w[nx];
    for (; i < pc.z; i += THREADS) {
        nx = min(i + THREADS, pc.z - 1);
        const float na = g_a[nx], np = g_p[nx], nwg = g_w[nx];
#pragma unroll
        for (int j = 0; j < T; ++j) {
            const float am = a - lA[j];
            const float e = expf(cg[j] + aA[j] * am - p * t1[j]) * wg;
            float* g = acc + j * S;
            g[0] += e;
            if constexpr (S > 1) {
                g[1] += e * am;
                g[2] += e * p;
            }
        }
        a = na;
        p = np;
        wg = nwg;
    }
    __shared__ double res[T * S];
    vg_block_sums<T * S>(acc, res);
    const int npieces = gridDim.x;
    if (threadIdx.x == 0)
        for (int j = 0; j < nw; ++j) {
            double* o = partial + ((size_t)(w0 + j) * npieces + blockIdx.x)
                * S;
#pragma unroll
            for (int k = 0; k < S; ++k) o[k] = res[j * S + k];
        }
    if (!vg_last_arrival(tickets, blockIdx.y, npieces)) return;

    // the tile's last block: its rows. Column 0 (the value) is slot 0
    // summed over all segments, negated. Hierarchical: column 1 of walker
    // j is slot 1 so summed; column 2 + 3f + k takes field f's segments:
    // -s0 (k = 0), aA s0 (k = 1), s2 (k = 2). Fixed: every column sums all
    // segments, slot and multiplier as in [-S0, -S0, -S1, aA S0, S2].
    vg_segment_sums<S>(partial, npieces, seg_sh, nseg, w0, nw, segsum);
    const int ncols = S == 1 ? 1 : (SHARED ? 5 : 2 + 3 * nfields);
    for (int c = threadIdx.x; c < nw * ncols; c += THREADS) {
        const int j = c / ncols;
        const int col = c - j * ncols;
        int f = -1, slot;
        double m;
        if (SHARED) {
            slot = col == 2 ? 1 : (col == 4 ? 2 : 0);
            m = col == 3 ? (double)fin[j] : (col == 4 ? 1.0 : -1.0);
        } else {
            f = col < 2 ? -1 : (col - 2) / HIER_SLOTS;
            const int k = col < 2 ? col : (col - 2) - f * HIER_SLOTS;
            slot = f >= 0 && k == 1 ? 0 : k;
            m = f < 0 || k == 0 ? -1.0 : (k == 1 ? (double)fin[j] : 1.0);
        }
        const double* ss = segsum + (size_t)j * nseg * S;
        double s = 0.0;
        for (int q = 0; q < nseg; ++q)
            if (f < 0 || seg_sh[q].x == f) s += ss[q * S + slot];
        out[(size_t)(w0 + j) * ncols + col] = m * s;
    }
    if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
}

template <int T, bool SHARED, int S>
static int launch_hier_vg(dim3 grid, size_t smem, cudaStream_t st,
                          const float* feats, int nwalkers, int nfeat,
                          int nfields, const float* g_a, const float* g_p,
                          const float* g_w, const int* pieces,
                          const int* segs, int nseg, double* partial,
                          int* tickets, double* out) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            hier_vg<T, SHARED, S>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    hier_vg<T, SHARED, S><<<grid, THREADS, smem, st>>>(
        feats, nwalkers, nfeat, nfields, g_a, g_p, g_w, (const int4*)pieces,
        (const int4*)segs, nseg, partial, tickets, out);
    return (int)cudaGetLastError();
}

// The checks of every launch of hier_vg: the shared memory of its finish
// and the grid's tiles.
static bool hier_vg_bad(int nwalkers, int tile, int npieces, int nseg,
                        size_t smem) {
    return nwalkers < 1 || tile < 1 || npieces < 1 || nseg < 1
        || nseg > npieces || (nwalkers + tile - 1) / tile > 65535
        || smem > 227 * 1024;
}

extern "C" {

// All pointers are device pointers; the stream is a cudaStream_t. Returns
// the cudaError_t of the launch (0 = success). Allocates nothing.
//
// hier_lnlike: pieces is the (npieces, 4) piece table and segs the (nseg,
// 4) segment table of one piece length (ops/cuda_lnlike.py _vg_tables),
// tile the walker tile (_vg_geometry: 1, 2, 4 or 8), partial a (W,
// npieces) double buffer, tickets the data's zeroed ticket buffer of at
// least ceil(W / tile) ints, out (W,) double. One launch.
int hier_lnlike_launch(const float* feats, int nwalkers, int nfeat,
                       int nfields,
                       const float* g_a, const float* g_p, const float* g_w,
                       const int* pieces, int npieces, const int* segs,
                       int nseg, int tile, double* partial, int* tickets,
                       double* out, void* stream) {
    const size_t smem = vg_smem(tile, nseg, 1);
    if (nfeat != 1 + 3 * nfields || nfields < 1
        || nfields > MAX_HIER_FIELDS
        || hier_vg_bad(nwalkers, tile, npieces, nseg, smem))
        return (int)cudaErrorInvalidValue;
    const dim3 grid(npieces, (nwalkers + tile - 1) / tile);
    cudaStream_t st = (cudaStream_t)stream;
#define HIER_VG_ARGS grid, smem, st, feats, nwalkers, nfeat, nfields, g_a, \
        g_p, g_w, pieces, segs, nseg, partial, tickets, out
    switch (tile) {
        case 1: return launch_hier_vg<1, false, 1>(HIER_VG_ARGS);
        case 2: return launch_hier_vg<2, false, 1>(HIER_VG_ARGS);
        case 4: return launch_hier_vg<4, false, 1>(HIER_VG_ARGS);
        case 8: return launch_hier_vg<8, false, 1>(HIER_VG_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
}

// hier_lnlike_vg: as hier_lnlike, tiles of 1, 2 or 4, partial a (W,
// npieces, HIER_SLOTS) double buffer, out (W, 2 + 3 nfields) double. One
// launch.
int hier_lnlike_vg_launch(const float* feats, int nwalkers, int nfeat,
                          int nfields,
                          const float* g_a, const float* g_p,
                          const float* g_w,
                          const int* pieces, int npieces, const int* segs,
                          int nseg, int tile, double* partial, int* tickets,
                          double* out, void* stream) {
    const size_t smem = vg_smem(tile, nseg, HIER_SLOTS);
    if (nfeat != 1 + 3 * nfields || nfields < 1
        || nfields > MAX_HIER_FIELDS
        || hier_vg_bad(nwalkers, tile, npieces, nseg, smem))
        return (int)cudaErrorInvalidValue;
    const dim3 grid(npieces, (nwalkers + tile - 1) / tile);
    cudaStream_t st = (cudaStream_t)stream;
    switch (tile) {
        case 1: return launch_hier_vg<1, false, HIER_SLOTS>(HIER_VG_ARGS);
        case 2: return launch_hier_vg<2, false, HIER_SLOTS>(HIER_VG_ARGS);
        case 4: return launch_hier_vg<4, false, HIER_SLOTS>(HIER_VG_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
}

// fixed_lnlike: as hier_lnlike, over the fixed-completeness data's tables
// (one segment a field), feature rows [c, aA, lA, t1], out (W,) double.
// One launch.
int fixed_lnlike_launch(const float* feats, int nwalkers, int nfeat,
                        const float* g_a, const float* g_p, const float* g_w,
                        const int* pieces, int npieces, const int* segs,
                        int nseg, int tile, double* partial, int* tickets,
                        double* out, void* stream) {
    const size_t smem = vg_smem(tile, nseg, 1);
    const int nfields = 0;      // not read: every piece takes the row
    if (nfeat != 4 || hier_vg_bad(nwalkers, tile, npieces, nseg, smem))
        return (int)cudaErrorInvalidValue;
    const dim3 grid(npieces, (nwalkers + tile - 1) / tile);
    cudaStream_t st = (cudaStream_t)stream;
    switch (tile) {
        case 1: return launch_hier_vg<1, true, 1>(HIER_VG_ARGS);
        case 2: return launch_hier_vg<2, true, 1>(HIER_VG_ARGS);
        case 4: return launch_hier_vg<4, true, 1>(HIER_VG_ARGS);
        case 8: return launch_hier_vg<8, true, 1>(HIER_VG_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
}

// fixed_lnlike_vg: as fixed_lnlike, tiles of 1, 2 or 4, partial a (W,
// npieces, HIER_SLOTS) double buffer, out (W, 5) double. One launch.
int fixed_lnlike_vg_launch(const float* feats, int nwalkers, int nfeat,
                           const float* g_a, const float* g_p,
                           const float* g_w,
                           const int* pieces, int npieces, const int* segs,
                           int nseg, int tile, double* partial,
                           int* tickets, double* out, void* stream) {
    const size_t smem = vg_smem(tile, nseg, HIER_SLOTS);
    const int nfields = 0;
    if (nfeat != 4 || hier_vg_bad(nwalkers, tile, npieces, nseg, smem))
        return (int)cudaErrorInvalidValue;
    const dim3 grid(npieces, (nwalkers + tile - 1) / tile);
    cudaStream_t st = (cudaStream_t)stream;
    switch (tile) {
        case 1: return launch_hier_vg<1, true, HIER_SLOTS>(HIER_VG_ARGS);
        case 2: return launch_hier_vg<2, true, HIER_SLOTS>(HIER_VG_ARGS);
        case 4: return launch_hier_vg<4, true, HIER_SLOTS>(HIER_VG_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
}
#undef HIER_VG_ARGS

}  // extern "C"
