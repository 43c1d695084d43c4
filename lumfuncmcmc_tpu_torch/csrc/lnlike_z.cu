// Redshift-evolving log-likelihood kernels for Hopper (sm_90a): the value
// kernel and its value + feature-gradient twin (the NUTS gradient path of
// the z model). A second source of the one kernel library: ops/_build.py
// compiles it together with lnlike.cu, with which it shares common.cuh.
//
// z_lnlike replaces the TPU kernels _kernel_z_bcast
// (lumfuncmcmc_tpu/ops/pallas_lnlike.py:659) and _kernel_z2_slab (:677):
// two VMEM layouts of one function there, one kernel here, in the slab
// kernel's factoring. z_lnlike_vg replaces _kernel_z_vg (:1142).
//
// What they compute, per walker w (feature row th = feats[w], 7 floats, see
// _feat_z_one in ops/cuda_lnlike.py), with dz = z - z2 the offset from the
// central pivot and luminosities relative to lref:
//   per z node:  lq = th3 dz^2 + th4 dz + th5    LN10 (Lstar(z) - lref)
//                pr = th0 dz^2 + th1 dz + th2    LN10 phistar(z) + ln ln10
//                t1 = exp(-lq)                   10^(lref - Lstar(z))
//                base = pr - th6 lq              (in double, then hi + lo)
//   lnl = - sum_cells exp(base + th6 a - P t1) * w
//         + sum_src   mask ? (pr_s + th6 x - exp(x) + lnOm_s) : 0,
//                     x = a_s - lq_s at the source's own dz
// a = LN10 (logL - lref) and P = 10^(logL - lref) are precomputed on the
// host, so a cell costs one exp and the node quantities one more per z node
// and band of L rows. z_lnlike_vg emits [lnl, d lnl/d th0..th6]: the
// derivatives factor over the L rows, so per z node three running sums
// (E, E P, E a) are contracted with dz, dz^2, t1 and lq at the end of the
// column, and a cell costs two multiplies more than in the value kernel
// (the TPU kernel's own accounting, pallas_lnlike.py:1152-1156). Its source
// part clamps x at 60, as the TPU kernel does; the value kernel does not.
//
// What bounds them on the card: at the fit's shape (5 fields x 201 x 201
// cells, W = 50 walkers per stretch half-step, W = 8 NUTS chains) a call is
// 1.6-10 M cell evaluations of 7-11 float32 operations, a few microseconds
// at the card's peak, over 2.4 MB of grid arrays that stay in L2 across
// walkers: launch latency and the dependent exp chain per thread bound it,
// not bytes. Both were first built in two passes: a (nchunks, W) grid,
// block (c, w) taking a band of ~2048 cells of one field for one walker,
// thread j owning z node j, then a small kernel summing each walker's
// (W, nchunks) partials in chunk order. At trapz-201 one node a thread
// left 55 of 256 lanes idle (224 at gauss-32), the node quantities were
// formed 21 times per (walker, node) and field, each block read its band
// for one walker, and the finish was a second launch: z_lnlike took 34.2
// us at W = 50, z_lnlike_vg 20.0 us at W = 8 and 220 us at W = 256, 5.6x
// the same-mix bound (PERF.md, H100 80GB HBM3). Both are now one launch a
// call, as hier_lnlike_vg (lnlike_h.cu):
//   - a (piece, walker tile) grid over bands of L rows and source pieces,
//     the band length and the walker tile picked on the host from W and
//     the SM count (ops/cuda_lnlike.py _vg_geometry, each kernel its own
//     tiles, VG_TILES): z_lnlike, one sum a walker, takes tiles of up to
//     8 walkers, z_lnlike_vg, eight, 1, 2 or 4; at trapz-201 z_lnlike_vg
//     takes at W = 1 bands of 5 rows (207 blocks), W = 8 tiles of 2
//     walkers on bands of 19 rows (224 blocks), W = 256 tiles of 4 on
//     bands of 67 rows (1024 blocks); the band's node quantities are
//     formed once per (walker, node) into shared memory;
//   - the block's threads take (node, row phase) pairs, so the lanes
//     share a long band's cells about evenly at any S_z (above 256 too:
//     201 nodes and 67 rows take 5 phases, 4 pairs a thread) and
//     neighbouring threads still read neighbouring addresses;
//   - a thread evaluates each cell it loads for every walker of its tile,
//     the next cell loaded before this one is computed;
//   - each column's sums are Kahan pairs in float32, the value is added up
//     per thread in double, and the source terms too: the grid integral and
//     the source sum cancel to O(1) out of ~N near the mode, and at 10^5
//     sources |lnL| ~ 1e6;
//   - the block reduces its T x K sums by vg_ticket.cuh's reduce-scatter,
//     writes its double partials and draws its tile's ticket; the tile's
//     last block sums them per segment in a fixed order (and for
//     z_lnlike_vg does the end-of-call contraction) in double: no finish
//     kernel, no float atomics, the same bits run to run (vg_ticket.cuh).
// Plain expf (no --use_fast_math), matching the plain PyTorch versions in
// ops/cuda_lnlike.py.

#include <cuda_runtime.h>

#include "common.cuh"
#include "vg_ticket.cuh"

#define Z_SLOTS 8        // ops/cuda_lnlike.py VG_Z_SLOTS
#define X_CLAMP 60.0f    // ops/cuda_lnlike.py X_CLAMP

// A z node's hoisted quantities, formed in double from the features and
// rounded once (ops/cuda_lnlike.py _z_node_rows): lq, t1 = exp(-lq) and
// base = pr - aA lq as hi + lo, added to a cell's exponent last, so the
// node's rounding error, which every cell of its column shares, stays at
// float32's precision of the whole exponent and not of base.
struct ZNode {
    float lq, t1, hi, lo;
};

// Where a launch of K slots keeps its band's node quantities in dynamic
// shared memory: past vg_smem's, rounded up to 16 bytes for their float4
// stores and loads (vg_smem of one slot and one walker ends 8 bytes past a
// multiple of 16 at an odd segment count: an even number of fields).
__host__ __device__ constexpr size_t z_node_off(int tile, int nseg, int k) {
    return (vg_smem(tile, nseg, k) + 15) & ~(size_t)15;
}

__device__ __forceinline__ ZNode z_node(const float* th, float dz,
                                        float dz2) {
    const double z1 = dz, z2 = dz2;
    const double lq = (double)th[3] * z2 + (double)th[4] * z1 + (double)th[5];
    const double base = (double)th[0] * z2 + (double)th[1] * z1
        + (double)th[2] - (double)th[6] * lq;
    const float lqf = (float)lq, hi = (float)base;
    return {lqf, expf(-lqf), hi, (float)(base - (double)hi)};
}

__device__ __forceinline__ float z_cell(const ZNode& n, float aA, float a,
                                        float p) {
    return expf(n.hi + ((aA * a - p * n.t1) + n.lo));
}

// z_lnlike: one kernel per call, z_vg's structure (below) with the value
// alone. Block (p, t) of a (piece, walker tile) grid runs piece p of the
// host's table (ops/cuda_lnlike.py _z_vg_tables) for the T walkers of tile
// t.
//   - A grid piece is a band of L rows [r0, r1) of field f's (S_L, S_z)
//     panel: the block forms the band's node quantities once per (walker,
//     node) into shared memory, then its threads take the band's (node,
//     phase) pairs (_z_phases) and run down their columns with one Kahan
//     pair per walker, loading the next cell before computing this one;
//     each column's sum goes into the thread's double value, negated.
//   - A source piece takes one source a thread a trip: ln phi + ln Omega,
//     x not clamped (z_lnlike_reference), each term float32, summed per
//     thread in double (a source piece hands a thread up to ~64 sources at
//     10^6: summed in float32 they cost the accept step's lnp differences
//     0.049 of the 0.05 it bears, PERF.md).
// The block's sums and the (W, npieces) partials are double; the tile's
// last block to draw its ticket adds each walker's partials segment by
// segment in a fixed order and writes its float64 value.
template <int T>
__global__ void __launch_bounds__(THREADS)
z_value(const float* __restrict__ feats, int nwalkers, int nfeat, int s_l,
        int s_z, const float* __restrict__ g_a, const float* __restrict__ g_p,
        const float* __restrict__ g_w, const float* __restrict__ n_dz,
        const float* __restrict__ n_dz2, const float* __restrict__ s_a,
        const float* __restrict__ s_dz, const float* __restrict__ s_dz2,
        const float* __restrict__ s_lnom0, const float* __restrict__ s_mask,
        const int4* __restrict__ pieces, const int4* __restrict__ segs,
        int nseg, int phases, double* __restrict__ partial,
        int* __restrict__ tickets, double* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];   // z_smem
    int4* seg_sh = (int4*)smem;         // the segment table, for the finish
    double* segsum = (double*)(smem + (size_t)nseg * sizeof(int4));
    float4* node = (float4*)(smem + z_node_off(T, nseg, 1));
    for (int s = threadIdx.x; s < nseg; s += THREADS) seg_sh[s] = segs[s];
    const int4 pc = pieces[blockIdx.x];  // (f, r0, r1, 0) or (0, i0, i1, 1)
    const int w0 = blockIdx.y * T;
    const int nw = min(T, nwalkers - w0);
    // rows past the last walker repeat the first, so only the writes are
    // guarded
    float aA[T];
#pragma unroll
    for (int j = 0; j < T; ++j)
        aA[j] = feats[(size_t)(w0 + (j < nw ? j : 0)) * nfeat + 6];
    double val[T];
#pragma unroll
    for (int j = 0; j < T; ++j) val[j] = 0.0;
    if (!pc.w) {
        // the band's node quantities of walker j, node n at j S_z + n
        const float* dzf = n_dz + (size_t)pc.x * s_z;
        const float* dz2f = n_dz2 + (size_t)pc.x * s_z;
        for (int q = threadIdx.x; q < T * s_z; q += THREADS) {
            const int j = q / s_z;
            const int n = q - j * s_z;
            const float dz = dzf[n], dz2 = dz2f[n];
            const ZNode z = z_node(
                feats + (size_t)(w0 + (j < nw ? j : 0)) * nfeat, dz, dz2);
            node[q] = make_float4(z.lq, z.t1, z.hi, z.lo);
        }
        __syncthreads();
        const size_t panel = (size_t)pc.x * s_l * s_z;
        const float* ga = g_a + panel;
        const float* gp = g_p + panel;
        const float* gw = g_w + panel;
        for (int q = threadIdx.x; q < s_z * phases; q += THREADS) {
            const int ph = q / s_z;
            const int n = q - ph * s_z;
            ZNode z[T];
            float col[T], comp[T];
#pragma unroll
            for (int j = 0; j < T; ++j) {
                const float4 v = node[j * s_z + n];
                z[j] = {v.x, v.y, v.z, v.w};
                col[j] = comp[j] = 0.0f;
            }
            // the last trip's prefetch re-reads the column's last cell
            int r = pc.y + ph;
            size_t nx = (size_t)min(r, pc.z - 1) * s_z + n;
            float a = ga[nx], p = gp[nx], wg = gw[nx];
            for (; r < pc.z; r += phases) {
                nx = (size_t)min(r + phases, pc.z - 1) * s_z + n;
                const float na = ga[nx], np = gp[nx], nwg = gw[nx];
#pragma unroll
                for (int j = 0; j < T; ++j)
                    kahan_add(col[j], comp[j],
                              z_cell(z[j], aA[j], a, p) * wg);
                a = na;
                p = np;
                wg = nwg;
            }
#pragma unroll
            for (int j = 0; j < T; ++j)
                val[j] -= (double)col[j] - (double)comp[j];
        }
    } else {
        float th[T][6];
#pragma unroll
        for (int j = 0; j < T; ++j)
#pragma unroll
            for (int k = 0; k < 6; ++k)
                th[j][k] = feats[(size_t)(w0 + (j < nw ? j : 0)) * nfeat + k];
        for (int i = pc.y + threadIdx.x; i < pc.z; i += THREADS) {
            if (s_mask[i] > 0.0f) {
                const float dz = s_dz[i], dz2 = s_dz2[i], sa = s_a[i];
                const float om = s_lnom0[i];
#pragma unroll
                for (int j = 0; j < T; ++j) {
                    const float x = sa
                        - (th[j][3] * dz2 + th[j][4] * dz + th[j][5]);
                    val[j] += th[j][0] * dz2 + th[j][1] * dz + th[j][2]
                        + aA[j] * x - expf(x) + om;
                }
            }
        }
    }
    __shared__ double res[T];
    vg_block_sums<T>(val, res);
    const int npieces = gridDim.x;
    if (threadIdx.x == 0)
        for (int j = 0; j < nw; ++j)
            partial[(size_t)(w0 + j) * npieces + blockIdx.x] = res[j];
    if (!vg_last_arrival(tickets, blockIdx.y, npieces)) return;

    // the tile's last block: each walker's segment sums, added in order
    vg_segment_sums<1>(partial, npieces, seg_sh, nseg, w0, nw, segsum);
    for (int j = threadIdx.x; j < nw; j += THREADS) {
        double s = 0.0;
        for (int q = 0; q < nseg; ++q) s += segsum[(size_t)j * nseg + q];
        out[w0 + j] = s;
    }
    if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
}

// z_lnlike_vg: one kernel per call, as hier_lnlike_vg (lnlike_h.cu). Block
// (p, t) of a (piece, walker tile) grid runs piece p of the host's table
// (ops/cuda_lnlike.py _z_vg_tables) for the T walkers of tile t.
//   - A grid piece is a band of L rows [r0, r1) of field f's (S_L, S_z)
//     panel. The block first forms the band's node quantities, once per
//     (walker, z node), into shared memory; then its threads take the
//     band's (node, phase) pairs q = node + S_z phase, q = threadIdx.x,
//     + THREADS, ... below S_z G, G = phases (picked on the host per band
//     length, _z_phases, so that the lanes share the band's cells about
//     evenly at any S_z). A pair runs down its node's column over the rows
//     r0 + phase, r0 + phase + G, ..., with one Kahan pair per walker for
//     its part of the column's value, and contracts its column sums with
//     its node's dz, dz^2, t1 and lq (from shared memory too) at the end:
//     the contraction is linear in the sums, so the pieces of a column add
//     up to the column's. A pair loads its next cell before it computes
//     this one.
//   - A source piece takes one source a thread a trip.
// Grid piece slots:   [SE, SE dz, SE dz^2, S(Ea - lq E), St1 EP, St1 EP dz,
//                      St1 EP dz^2, 0]
// Source piece slots: [Scontrib, Sm, Sm dz, Sm dz^2, Sm x, Sm r, Sm r dz,
//                      Sm r dz^2], r = th6 - exp(x), x clamped at X_CLAMP.
// Float32 per thread, the value slot double (a source piece hands a thread
// ~60 terms of ~13 at 10^6 sources: summed in float32 they cost the lnp
// differences of close thetas 0.049 where the gate is 0.05, PERF.md), the
// block's reduction and the (W, npieces, Z_SLOTS) partials double. The
// tile's last block to draw its ticket sums them over the grid segments
// (G_k) and the source segments (S_k) in a fixed order and writes
//   [-G0 + S0, -G2 + S3, -G1 + S2, -G0 + S1, th6 G2 - G6 - S7,
//    th6 G1 - G5 - S6, th6 G0 - G4 - S5, -G3 + S4].
// Tiles of 4 are held to 3 blocks an SM (at most 85 registers; 117
// unbounded, 2 blocks an SM, ran 8% slower at W = 256: PERF.md).
template <int T>
__global__ void __launch_bounds__(THREADS, T == 4 ? 3 : 1)
z_vg(const float* __restrict__ feats, int nwalkers, int nfeat, int s_l,
     int s_z, const float* __restrict__ g_a, const float* __restrict__ g_p,
     const float* __restrict__ g_w, const float* __restrict__ n_dz,
     const float* __restrict__ n_dz2, const float* __restrict__ s_a,
     const float* __restrict__ s_dz, const float* __restrict__ s_dz2,
     const float* __restrict__ s_lnom0, const float* __restrict__ s_mask,
     const int4* __restrict__ pieces, const int4* __restrict__ segs,
     int nseg, int phases, double* __restrict__ partial,
     int* __restrict__ tickets, double* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];   // z_smem
    int4* seg_sh = (int4*)smem;         // the segment table, for the finish
    double* segsum = (double*)(smem + (size_t)nseg * sizeof(int4));
    // the band's node quantities (lq, t1, hi, lo) of walker j, node n at
    // j S_z + n, then (dz, dz^2) of node n at n
    float4* node = (float4*)(smem + z_node_off(T, nseg, Z_SLOTS));
    float2* ndz = (float2*)(node + T * s_z);
    for (int s = threadIdx.x; s < nseg; s += THREADS) seg_sh[s] = segs[s];
    const int4 pc = pieces[blockIdx.x];  // (f, r0, r1, 0) or (0, i0, i1, 1)
    const int w0 = blockIdx.y * T;
    const int nw = min(T, nwalkers - w0);
    // rows past the last walker repeat the first, so only the writes are
    // guarded
    __shared__ float fin[T];            // th6, for the finish
    float aA[T];
#pragma unroll
    for (int j = 0; j < T; ++j) {
        aA[j] = feats[(size_t)(w0 + (j < nw ? j : 0)) * nfeat + 6];
        if (threadIdx.x == 0) fin[j] = aA[j];
    }
    float acc[T * Z_SLOTS];
#pragma unroll
    for (int k = 0; k < T * Z_SLOTS; ++k) acc[k] = 0.0f;
    double val[T];                      // the value slot, per walker
#pragma unroll
    for (int j = 0; j < T; ++j) val[j] = 0.0;
    if (!pc.w) {
        const float* dzf = n_dz + (size_t)pc.x * s_z;
        const float* dz2f = n_dz2 + (size_t)pc.x * s_z;
        for (int q = threadIdx.x; q < T * s_z; q += THREADS) {
            const int j = q / s_z;
            const int n = q - j * s_z;
            const float dz = dzf[n], dz2 = dz2f[n];
            const ZNode z = z_node(
                feats + (size_t)(w0 + (j < nw ? j : 0)) * nfeat, dz, dz2);
            node[q] = make_float4(z.lq, z.t1, z.hi, z.lo);
            if (j == 0) ndz[n] = make_float2(dz, dz2);
        }
        __syncthreads();
        const size_t panel = (size_t)pc.x * s_l * s_z;
        const float* ga = g_a + panel;
        const float* gp = g_p + panel;
        const float* gw = g_w + panel;
        for (int q = threadIdx.x; q < s_z * phases; q += THREADS) {
            const int ph = q / s_z;
            const int n = q - ph * s_z;
            ZNode z[T];
            float col[T], comp[T], ep[T], ea[T];
#pragma unroll
            for (int j = 0; j < T; ++j) {
                const float4 v = node[j * s_z + n];
                z[j] = {v.x, v.y, v.z, v.w};
                col[j] = comp[j] = ep[j] = ea[j] = 0.0f;
            }
            // the last trip's prefetch re-reads the column's last cell
            int r = pc.y + ph;
            size_t nx = (size_t)min(r, pc.z - 1) * s_z + n;
            float a = ga[nx], p = gp[nx], wg = gw[nx];
            for (; r < pc.z; r += phases) {
                nx = (size_t)min(r + phases, pc.z - 1) * s_z + n;
                const float na = ga[nx], np = gp[nx], nwg = gw[nx];
#pragma unroll
                for (int j = 0; j < T; ++j) {
                    const float e = z_cell(z[j], aA[j], a, p) * wg;
                    kahan_add(col[j], comp[j], e);
                    ep[j] += e * p;
                    ea[j] += e * a;
                }
                a = na;
                p = np;
                wg = nwg;
            }
            const float2 d = ndz[n];
#pragma unroll
            for (int j = 0; j < T; ++j) {
                float* g = acc + j * Z_SLOTS;
                const float tp = z[j].t1 * ep[j];
                val[j] += (double)col[j] - (double)comp[j];
                g[1] += col[j] * d.x;
                g[2] += col[j] * d.y;
                g[3] += ea[j] - z[j].lq * col[j];
                g[4] += tp;
                g[5] += tp * d.x;
                g[6] += tp * d.y;
            }
        }
    } else {
        float th[T][6];
#pragma unroll
        for (int j = 0; j < T; ++j)
#pragma unroll
            for (int k = 0; k < 6; ++k)
                th[j][k] = feats[(size_t)(w0 + (j < nw ? j : 0)) * nfeat + k];
        float sm = 0.0f, smz = 0.0f, smz2 = 0.0f;
        for (int i = pc.y + threadIdx.x; i < pc.z; i += THREADS) {
            const float m = s_mask[i];
            if (m > 0.0f) {
                const float dz = s_dz[i], dz2 = s_dz2[i], sa = s_a[i];
                const float om = s_lnom0[i];
                sm += m;
                smz += m * dz;
                smz2 += m * dz2;
#pragma unroll
                for (int j = 0; j < T; ++j) {
                    const float x = fminf(
                        sa - (th[j][3] * dz2 + th[j][4] * dz + th[j][5]),
                        X_CLAMP);
                    const float ex = expf(x);
                    const float mr = m * (aA[j] - ex);
                    float* g = acc + j * Z_SLOTS;
                    val[j] += th[j][0] * dz2 + th[j][1] * dz + th[j][2]
                        + aA[j] * x - ex + om;
                    g[4] += m * x;
                    g[5] += mr;
                    g[6] += mr * dz;
                    g[7] += mr * dz2;
                }
            }
        }
#pragma unroll
        for (int j = 0; j < T; ++j) {
            acc[j * Z_SLOTS + 1] = sm;
            acc[j * Z_SLOTS + 2] = smz;
            acc[j * Z_SLOTS + 3] = smz2;
        }
    }
    double v[T * Z_SLOTS];
#pragma unroll
    for (int k = 0; k < T * Z_SLOTS; ++k) v[k] = acc[k];
#pragma unroll
    for (int j = 0; j < T; ++j) v[j * Z_SLOTS] += val[j];
    __shared__ double res[T * Z_SLOTS];
    vg_block_sums<T * Z_SLOTS>(v, res);
    const int npieces = gridDim.x;
    if (threadIdx.x == 0)
        for (int j = 0; j < nw; ++j) {
            double* o = partial + ((size_t)(w0 + j) * npieces + blockIdx.x)
                * Z_SLOTS;
#pragma unroll
            for (int k = 0; k < Z_SLOTS; ++k) o[k] = res[j * Z_SLOTS + k];
        }
    if (!vg_last_arrival(tickets, blockIdx.y, npieces)) return;

    // the tile's last block: G_k and S_k of each walker (column c of its
    // 2 Z_SLOTS sums, the segments of one kind added in order), then its row
    vg_segment_sums<Z_SLOTS>(partial, npieces, seg_sh, nseg, w0, nw,
                             segsum);
    __shared__ double tot[T][2 * Z_SLOTS];
    const int ncols = 2 * Z_SLOTS;
    for (int c = threadIdx.x; c < nw * ncols; c += THREADS) {
        const int j = c / ncols;
        const int col = c - j * ncols;
        const int src = col >= Z_SLOTS;
        const double* ss = segsum + (size_t)j * nseg * Z_SLOTS
            + (col - src * Z_SLOTS);
        double s = 0.0;
        for (int q = 0; q < nseg; ++q)
            if (seg_sh[q].w == src) s += ss[q * Z_SLOTS];
        tot[j][col] = s;
    }
    __syncthreads();
    if (threadIdx.x < nw) {
        const int j = threadIdx.x;
        const double* G = tot[j];
        const double* S = tot[j] + Z_SLOTS;
        const double th6 = (double)fin[j];
        double* o = out + (size_t)(w0 + j) * 8;
        o[0] = -G[0] + S[0];
        o[1] = -G[2] + S[3];
        o[2] = -G[1] + S[2];
        o[3] = -G[0] + S[1];
        o[4] = th6 * G[2] - G[6] - S[7];
        o[5] = th6 * G[1] - G[5] - S[6];
        o[6] = th6 * G[0] - G[4] - S[5];
        o[7] = -G[3] + S[4];
    }
    if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
}

// Dynamic shared memory of a launch of K slots: vg_smem's, then from
// z_node_off the band's node quantities of T walkers, and for z_vg (K
// Z_SLOTS) its nodes' (dz, dz^2).
static size_t z_smem(int tile, int nseg, int s_z, int k) {
    return z_node_off(tile, nseg, k) + (size_t)s_z
        * (tile * sizeof(float4) + (k > 1 ? sizeof(float2) : 0));
}

// Launch z_value<T> or z_vg<T> (kernel, one argument list).
template <typename Kernel>
static int launch_z(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st,
                    const float* feats, int nwalkers, int nfeat, int s_l,
                    int s_z, const float* g_a, const float* g_p,
                    const float* g_w, const float* n_dz, const float* n_dz2,
                    const float* s_a, const float* s_dz, const float* s_dz2,
                    const float* s_lnom0, const float* s_mask,
                    const int* pieces, const int* segs, int nseg, int phases,
                    double* partial, int* tickets, double* out) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, THREADS, smem, st>>>(
        feats, nwalkers, nfeat, s_l, s_z, g_a, g_p, g_w, n_dz, n_dz2, s_a,
        s_dz, s_dz2, s_lnom0, s_mask, (const int4*)pieces,
        (const int4*)segs, nseg, phases, partial, tickets, out);
    return (int)cudaGetLastError();
}

// The checks of every launch of either kernel.
static bool z_bad(int nfeat, int nwalkers, int s_l, int s_z, int tile,
                  int phases, int npieces, int nseg, size_t smem) {
    return nfeat != 7 || nwalkers < 1 || s_l < 1 || s_z < 1 || tile < 1
        || phases < 1 || npieces < 1 || nseg < 1 || nseg > npieces
        || (nwalkers + tile - 1) / tile > 65535 || smem > 227 * 1024;
}

extern "C" {

// All pointers are device pointers; the stream is a cudaStream_t. Returns
// the cudaError_t of the launch (0 = success). Allocates nothing.
//
// z_lnlike: pieces is the (npieces, 4) band and source piece table and segs
// the (nseg, 4) segment table of one band length (ops/cuda_lnlike.py
// _z_vg_tables), tile the walker tile (_vg_geometry: 1, 2, 4 or 8), phases
// the row phases of its bands (_z_phases), partial a (W, npieces) double
// buffer, tickets the data's zeroed ticket buffer of at least ceil(W /
// tile) ints, out (W,) double. One launch.
int z_lnlike_launch(const float* feats, int nwalkers, int nfeat, int s_l,
                    int s_z,
                    const float* g_a, const float* g_p, const float* g_w,
                    const float* n_dz, const float* n_dz2,
                    const float* s_a, const float* s_dz, const float* s_dz2,
                    const float* s_lnom0, const float* s_mask,
                    const int* pieces, int npieces, const int* segs,
                    int nseg, int tile, int phases, double* partial,
                    int* tickets, double* out, void* stream) {
    const size_t smem = z_smem(tile, nseg, s_z, 1);
    if (z_bad(nfeat, nwalkers, s_l, s_z, tile, phases, npieces, nseg, smem))
        return (int)cudaErrorInvalidValue;
    const dim3 grid(npieces, (nwalkers + tile - 1) / tile);
    cudaStream_t st = (cudaStream_t)stream;
#define Z_ARGS grid, smem, st, feats, nwalkers, nfeat, s_l, s_z, g_a, g_p, \
        g_w, n_dz, n_dz2, s_a, s_dz, s_dz2, s_lnom0, s_mask, pieces, segs, \
        nseg, phases, partial, tickets, out
    switch (tile) {
        case 1: return launch_z(z_value<1>, Z_ARGS);
        case 2: return launch_z(z_value<2>, Z_ARGS);
        case 4: return launch_z(z_value<4>, Z_ARGS);
        case 8: return launch_z(z_value<8>, Z_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
}

// z_lnlike_vg: as z_lnlike, tiles of 1, 2 or 4, partial a (W, npieces,
// Z_SLOTS) double buffer, out (W, 8) double. One launch.
int z_lnlike_vg_launch(const float* feats, int nwalkers, int nfeat, int s_l,
                       int s_z,
                       const float* g_a, const float* g_p, const float* g_w,
                       const float* n_dz, const float* n_dz2,
                       const float* s_a, const float* s_dz,
                       const float* s_dz2,
                       const float* s_lnom0, const float* s_mask,
                       const int* pieces, int npieces, const int* segs,
                       int nseg, int tile, int phases, double* partial,
                       int* tickets, double* out, void* stream) {
    const size_t smem = z_smem(tile, nseg, s_z, Z_SLOTS);
    if (z_bad(nfeat, nwalkers, s_l, s_z, tile, phases, npieces, nseg, smem))
        return (int)cudaErrorInvalidValue;
    const dim3 grid(npieces, (nwalkers + tile - 1) / tile);
    cudaStream_t st = (cudaStream_t)stream;
    switch (tile) {
        case 1: return launch_z(z_vg<1>, Z_ARGS);
        case 2: return launch_z(z_vg<2>, Z_ARGS);
        case 4: return launch_z(z_vg<4>, Z_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
}
#undef Z_ARGS

}  // extern "C"
