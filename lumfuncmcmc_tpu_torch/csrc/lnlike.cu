// Single-epoch free-completeness log-likelihood kernels for Hopper
// (sm_90a): the value kernel (the stretch path of `fit`) and its value +
// feature-gradient twin (the NUTS gradient path), one kernel body. The
// fixed-completeness pair is hier_lnlike_vg's kernel body with the features
// shared by every field, in lnlike_h.cu; its rows are described here. The
// z model's kernels are in lnlike_z.cu; the sources share common.cuh (block
// size, block reduction, the ln fc terms) and vg_ticket.cuh (the one-launch
// finish), and are compiled into one library by ops/_build.py.
//
// free_lnlike replaces the TPU kernels _kernel_free_bcast
// (lumfuncmcmc_tpu/ops/pallas_lnlike.py:601) and _kernel_free (:761);
// fixed_lnlike (lnlike_h.cu) replaces _kernel_fixed_bcast (:751) and
// _kernel_fixed (:813). The TPU's broadcast/slab variants are two VMEM
// layouts of one computation; here one layout serves every catalog size.
// free_lnlike_vg replaces _kernel_free_vg (:832); fixed_lnlike_vg
// (lnlike_h.cu) replaces _kernel_fixed_vg (:1255).
//
// What they compute, per walker w (feature row th = feats[w]):
//   free:  sum over fields f of
//            - sum_cells  exp(c_g + aA (a - lA) - P t1 + ln fc) * w
//            + sum_src    mask ? (c_s + aA (a - lA) - P t1 + lnOm0 + ln fc) : 0
//          ln fc = ln max(0.5 + 0.5 x rsqrt(1 + x^2), 1e-30), x = ac (logf - lF50_f),
//          divided by (1 - exp(-R t2_f)) when fcmin is set.
//   fixed: - sum_cells exp(c + aA (a - lA) - P t1) * w
//          (its collapsed source term is added on the host, in float64,
//          from the same rounded features: ops/cuda_lnlike.py
//          _fixed_collapsed)
// P = 10^(logL - lref) and R = 10^(logf + 16) are precomputed on the
// host, so the per-element work is 2 exp + 1 log + 1 rsqrt + 1 div (free)
// or 1 exp (fixed).
// The _vg kernels emit, per walker, that lnlike AND its derivative with
// respect to every feature of the row, in one pass over the cells:
//   free:  [lnl, d_cg, d_cs, d_aA, d_lA, d_t1, d_ac, d_lf50_f.., d_t2_f..]
//   fixed: [lnl, d_c, d_aA, d_lA, d_t1]
// The theta -> feature pullback is left to autograd of the cheap feature
// map (ops/cuda_lnlike.py: make_cuda_lnprob_and_grad). Per cell the
// derivative needs, beyond the forward's terms, only products of what the
// forward already computes: u = rsqrt(1 + x^2) is reused for u^3
// (d ln fc/dx = 0.5 u^3 / fc) and q = exp(-R t2) for the t2 derivative, so
// there is no transcendental beyond the value kernel's (the TPU kernel's
// own accounting, pallas_lnlike.py:841-843).
//
// What bounds them on the card: transcendental throughput and launch
// latency. At the stretch fit's shape (W = 50 walkers x 51,005 cells) one
// value call is ~2.6 M cell evaluations: a few microseconds of SFU work,
// with the grid arrays (1 MB) resident in L2 across walkers. At the NUTS
// shape (W = 8 chains) a value+gradient call is ~0.4 M cell evaluations
// of ~50 float32 operations each, a fraction of a microsecond at the
// card's peak rates: launch latency and the dependent transcendental chain
// per thread bound it; at W = 256 the SFU rate takes over. Both were
// first built in two passes: a (nchunks, W) grid, block (c, w) reducing
// chunk c (at most 2048 cells or sources of one field) for one walker
// into a (W, nchunks) double scratch, then a small kernel summing each
// walker's partials in chunk order. The finish pass alone took 4-8 us a
// call whatever W, and each block read its chunk from L2 once per walker
// (PERF.md, H100 80GB HBM3). Both are now one launch a call of one kernel
// body:
//   - a (piece, walker tile) grid: the host cuts every field's cells and
//     sources into near-equal pieces of one length and picks the length
//     and the tile from W and the SM count (ops/cuda_lnlike.py
//     _vg_geometry, each kernel its own tiles, VG_TILES): the value
//     kernel, one sum a walker, takes tiles of 1, 2 or 4 walkers (tiles of
//     8 held 105 registers, 2 blocks an SM, and ran 7-9% slower at W =
//     1200-2400); the value+gradient kernel, seven sums a walker, 1 or 2
//     (tiles of 4 held 99 registers, 2 blocks an SM, and ran slower). So a
//     cell is read once per tile and a thread runs up to T independent
//     rsqrt -> logf -> divide -> expf chains;
//   - each thread loads its next cell before it computes this one;
//   - the block reduces its T x S float32 sums in double by a
//     reduce-scatter over the lanes (vg_ticket.cuh vg_block_sums: ~T x S
//     double shuffles a warp, where a shuffle tree per sum takes five times
//     that), writes its partials and draws its tile's ticket; the last
//     block of the tile sums the tile's partials per segment in a fixed
//     order, routes each segment's slots to its columns (d_lf50/d_t2 to
//     the segment's field) and writes float64 (vg_ticket.cuh): one kernel
//     node per call, no float atomics, the same bits run to run, and the
//     cancellation of the grid integral against the source sum (lnl, and
//     d_cg + d_cs ~ -integral + N near the mode) happens in double.
// Plain expf/logf/rsqrtf (no --use_fast_math), matching the plain PyTorch
// versions in ops/cuda_lnlike.py, but for the value kernel's ln fc: its
// log and its divide by 1 - exp(-R t2) are the SFU's (__logf,
// __fdividef: ln_fc_sfu). The IEEE divide calls a slow path and the
// accurate logf is ~30 instructions longer, which keeps the compiler from
// interleaving the T walkers' chains: free_lnlike took 15.7 us at W = 50
// so, 12.2 with the SFU's (PERF.md, H100 80GB HBM3), within 1e-7 of the
// plain version.

#include <cuda_runtime.h>

#include "common.cuh"
#include "vg_ticket.cuh"

#define FREE_SLOTS 7     // ops/cuda_lnlike.py VG_FREE_SLOTS

// ln_fc (common.cuh) with the SFU's log and divide: __logf is within
// 2^-21.4 of ln fc for fc in [0.5, 1] and 3 ulp below, __fdividef 2 ulp
// for a divisor 1 - exp(-R t2) in (0, 1].
__device__ __forceinline__ float ln_fc_sfu(float logf_, float r, float ac,
                                           float lf50, float t2, int fcmin) {
    const float x = ac * (logf_ - lf50);
    const float fc = fmaxf(0.5f + 0.5f * x * rsqrtf(1.0f + x * x), 1e-30f);
    const float lf = __logf(fc);
    if (!fcmin) return lf;
    return __fdividef(lf, 1.0f - expf(-(r * t2)));
}

// A cell's or source's ln fc for S slots: the value kernel (S 1) takes
// ln_fc_sfu; the value + gradient kernel takes fc_terms, ln fc with its
// derivatives.
template <int S>
__device__ __forceinline__ FcTerms fc_slots(float logf_, float r, float ac,
                                            float lf50, float t2,
                                            int fcmin) {
    if constexpr (S == 1)
        return {ln_fc_sfu(logf_, r, ac, lf50, t2, fcmin), 0.0f, 0.0f};
    else
        return fc_terms(logf_, r, ac, lf50, t2, fcmin);
}

// free_lnlike (S 1) and free_lnlike_vg (S FREE_SLOTS): one kernel per
// call. Block (p, t) of a (piece, walker tile) grid runs piece p of the
// host's piece table (vg_ticket.cuh) for the T walkers of tile t: each
// thread takes one cell (or source) a loop trip, the next trip's loaded
// before this one's is computed, and evaluates it against every walker of
// the tile from registers, so a trip holds T independent rsqrt -> logf ->
// divide -> expf chains and each cell is read once per tile, not once per
// walker.
// Grid piece slots:   [Se] (S 1), or
//                     [Se, Se*am, Se*P, Se*dfx*dl, Se*dfx, Se*dft, 0]
// Source piece slots: [Scontrib] (S 1), or
//                     [Scontrib, Sm, Sm*am, Sm*P, Sm*dfx*dl, Sm*dfx, Sm*dft]
// with am = a - lA, dl = logf - lF50_f, S over the piece's cells, per
// walker; float32 per thread, then the block's double reduction into the
// (W, npieces, S) double partials. The tile's last block to draw its ticket
// sums them per segment in a fixed order and routes each segment's slots
// to the columns of the row, lnl = -Sum grid + Sum source (S 1) or [lnl,
// d_cg, d_cs, d_aA, d_lA, d_t1, d_ac, d_lf50_f.., d_t2_f..]: each column
// takes one slot of a grid segment and one of a source segment, times a
// multiplier (0: no term), the per-field columns only their field's
// segments.
template <int T, int S>
__global__ void __launch_bounds__(THREADS)
free_vg(const float* __restrict__ feats, int nwalkers, int nfeat,
        int nfields,
        const float* __restrict__ g_logf, const float* __restrict__ g_a,
        const float* __restrict__ g_p, const float* __restrict__ g_r,
        const float* __restrict__ g_w,
        const float* __restrict__ s_logf, const float* __restrict__ s_a,
        const float* __restrict__ s_p, const float* __restrict__ s_r,
        const float* __restrict__ s_lnom0, const float* __restrict__ s_mask,
        const int4* __restrict__ pieces, const int4* __restrict__ segs,
        int nseg, int fcmin, double* __restrict__ partial,
        int* __restrict__ tickets, double* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];   // vg_smem
    int4* seg_sh = (int4*)smem;         // the segment table, for the finish
    double* segsum = (double*)(smem + (size_t)nseg * sizeof(int4));
    for (int s = threadIdx.x; s < nseg; s += THREADS) seg_sh[s] = segs[s];
    const int4 pc = pieces[blockIdx.x];     // (field, start, end, is_source)
    const int w0 = blockIdx.y * T;
    const int nw = min(T, nwalkers - w0);
    // the tile's features; rows past the last walker repeat the first, so
    // every thread runs the same T-wide loop and only the writes are guarded
    float c0[T], aA[T], lA[T], t1[T], ac[T], lf50[T], t2[T];
    __shared__ float fin[T][2];         // aA and ac, for the finish
#pragma unroll
    for (int j = 0; j < T; ++j) {
        const float* th = feats + (size_t)(w0 + (j < nw ? j : 0)) * nfeat;
        c0[j] = th[pc.w ? 1 : 0];
        aA[j] = th[2];
        lA[j] = th[3];
        t1[j] = th[4];
        ac[j] = th[5];
        lf50[j] = th[6 + pc.x];
        t2[j] = th[6 + nfields + pc.x];
        if (threadIdx.x == 0) {
            fin[j][0] = aA[j];
            fin[j][1] = ac[j];
        }
    }
    float acc[T * S];
#pragma unroll
    for (int k = 0; k < T * S; ++k) acc[k] = 0.0f;
    // the last trip's prefetch re-reads the piece's last cell
    int i = pc.y + threadIdx.x;
    int nx = min(i, pc.z - 1);
    if (!pc.w) {
        float lf = g_logf[nx], a = g_a[nx], p = g_p[nx], r = g_r[nx];
        float wg = g_w[nx];
        for (; i < pc.z; i += THREADS) {
            nx = min(i + THREADS, pc.z - 1);
            const float nlf = g_logf[nx], na = g_a[nx], np = g_p[nx];
            const float nr = g_r[nx], nwg = g_w[nx];
#pragma unroll
            for (int j = 0; j < T; ++j) {
                const FcTerms t = fc_slots<S>(lf, r, ac[j], lf50[j], t2[j],
                                              fcmin);
                const float am = a - lA[j];
                const float e = expf(c0[j] + aA[j] * am - p * t1[j]
                                     + t.lnfc) * wg;
                float* g = acc + j * S;
                g[0] += e;
                if constexpr (S > 1) {
                    const float edfx = e * t.dfx;
                    g[1] += e * am;
                    g[2] += e * p;
                    g[3] += edfx * (lf - lf50[j]);
                    g[4] += edfx;
                    g[5] += e * t.dft;
                }
            }
            lf = nlf;
            a = na;
            p = np;
            r = nr;
            wg = nwg;
        }
    } else {
        float m = s_mask[nx], lf = s_logf[nx], a = s_a[nx], p = s_p[nx];
        float r = s_r[nx], om = s_lnom0[nx];
        for (; i < pc.z; i += THREADS) {
            nx = min(i + THREADS, pc.z - 1);
            const float nm = s_mask[nx], nlf = s_logf[nx], na = s_a[nx];
            const float np = s_p[nx], nr = s_r[nx], nom = s_lnom0[nx];
            if (m > 0.0f) {
#pragma unroll
                for (int j = 0; j < T; ++j) {
                    const FcTerms t = fc_slots<S>(lf, r, ac[j], lf50[j],
                                                  t2[j], fcmin);
                    const float am = a - lA[j];
                    float* g = acc + j * S;
                    g[0] += c0[j] + aA[j] * am - p * t1[j] + om + t.lnfc;
                    if constexpr (S > 1) {
                        const float mdfx = m * t.dfx;
                        g[1] += m;
                        g[2] += m * am;
                        g[3] += m * p;
                        g[4] += mdfx * (lf - lf50[j]);
                        g[5] += mdfx;
                        g[6] += m * t.dft;
                    }
                }
            }
            m = nm;
            lf = nlf;
            a = na;
            p = np;
            r = nr;
            om = nom;
        }
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

    // the tile's last block: its rows (S 1: column 0 alone)
    vg_segment_sums<S>(partial, npieces, seg_sh, nseg, w0, nw, segsum);
    const int ncols = S == 1 ? 1 : 1 + nfeat;
    for (int c = threadIdx.x; c < nw * ncols; c += THREADS) {
        const int j = c / ncols;
        const int col = c - j * ncols;
        const double aAd = fin[j][0], acd = fin[j][1];
        const int field = col < 7 ? -1 : (col - 7) % nfields;
        // (grid slot, multiplier), (source slot, multiplier) of this column
        int gk = 0, sk = 0;
        double gm = 0.0, sm = 0.0;
        switch (col < 7 ? col : (col < 7 + nfields ? 7 : 8)) {
            case 0: gm = -1.0; sm = 1.0; break;                 // lnl
            case 1: gm = -1.0; break;                           // d_cg
            case 2: sk = 1; sm = 1.0; break;                    // d_cs
            case 3: gk = 1; gm = -1.0; sk = 2; sm = 1.0; break; // d_aA
            case 4: gm = aAd; sk = 1; sm = -aAd; break;         // d_lA
            case 5: gk = 2; gm = 1.0; sk = 3; sm = -1.0; break; // d_t1
            case 6: gk = 3; gm = -1.0; sk = 4; sm = 1.0; break; // d_ac
            case 7: gk = 4; gm = acd; sk = 5; sm = -acd; break; // d_lf50_f
            default: gk = 5; gm = -1.0; sk = 6; sm = 1.0;       // d_t2_f
        }
        const double* ss = segsum + (size_t)j * nseg * S;
        double s = 0.0;
        for (int q = 0; q < nseg; ++q) {
            const int4 sg = seg_sh[q];
            const double m = sg.w ? sm : gm;
            if (m != 0.0 && (field < 0 || sg.x == field))
                s += m * ss[q * S + (sg.w ? sk : gk)];
        }
        out[(size_t)(w0 + j) * ncols + col] = s;
    }
    if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
}

template <int T, int S>
static int launch_free_vg(dim3 grid, size_t smem, cudaStream_t st,
                          const float* feats, int nwalkers, int nfeat,
                          int nfields, const float* g_logf, const float* g_a,
                          const float* g_p, const float* g_r,
                          const float* g_w, const float* s_logf,
                          const float* s_a, const float* s_p,
                          const float* s_r, const float* s_lnom0,
                          const float* s_mask, const int* pieces,
                          const int* segs, int nseg, int fcmin,
                          double* partial, int* tickets, double* out) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            free_vg<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    free_vg<T, S><<<grid, THREADS, smem, st>>>(
        feats, nwalkers, nfeat, nfields, g_logf, g_a, g_p, g_r, g_w, s_logf,
        s_a, s_p, s_r, s_lnom0, s_mask, (const int4*)pieces,
        (const int4*)segs, nseg, fcmin, partial, tickets, out);
    return (int)cudaGetLastError();
}

// The checks of every launch of free_vg: the feature row, the shared memory
// of its finish and the grid's tiles.
static bool free_vg_bad(int nwalkers, int nfeat, int nfields, int tile,
                        int npieces, int nseg, size_t smem) {
    return nfeat != 6 + 2 * nfields || nwalkers < 1 || tile < 1
        || npieces < 1 || nseg < 1 || nseg > npieces
        || (nwalkers + tile - 1) / tile > 65535 || smem > 227 * 1024;
}

static __global__ void empty_kernel() {}

extern "C" {

// All pointers are device pointers; the stream is a cudaStream_t. Returns
// the cudaError_t of the launch (0 = success). Allocates nothing.
//
// free_lnlike: pieces is the (npieces, 4) piece table and segs the (nseg,
// 4) segment table of one piece length (ops/cuda_lnlike.py _vg_tables),
// tile the walker tile (_vg_geometry: 1, 2 or 4), partial a (W, npieces)
// double buffer, tickets the data's zeroed ticket buffer of at least
// ceil(W / tile) ints, out (W,) double. One launch.
int free_lnlike_launch(const float* feats, int nwalkers, int nfeat,
                       int nfields,
                       const float* g_logf, const float* g_a,
                       const float* g_p, const float* g_r, const float* g_w,
                       const float* s_logf, const float* s_a,
                       const float* s_p, const float* s_r,
                       const float* s_lnom0, const float* s_mask,
                       const int* pieces, int npieces, const int* segs,
                       int nseg, int tile, int fcmin, double* partial,
                       int* tickets, double* out, void* stream) {
    const size_t smem = vg_smem(tile, nseg, 1);
    if (free_vg_bad(nwalkers, nfeat, nfields, tile, npieces, nseg, smem))
        return (int)cudaErrorInvalidValue;
    const dim3 grid(npieces, (nwalkers + tile - 1) / tile);
    cudaStream_t st = (cudaStream_t)stream;
#define FREE_VG_ARGS grid, smem, st, feats, nwalkers, nfeat, nfields, \
        g_logf, g_a, g_p, g_r, g_w, s_logf, s_a, s_p, s_r, s_lnom0, s_mask, \
        pieces, segs, nseg, fcmin, partial, tickets, out
    switch (tile) {
        case 1: return launch_free_vg<1, 1>(FREE_VG_ARGS);
        case 2: return launch_free_vg<2, 1>(FREE_VG_ARGS);
        case 4: return launch_free_vg<4, 1>(FREE_VG_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
}

// free_lnlike_vg: as free_lnlike, tiles of 1 or 2, partial a (W, npieces,
// FREE_SLOTS) double buffer, out (W, 1 + nfeat) double. One launch.
int free_lnlike_vg_launch(const float* feats, int nwalkers, int nfeat,
                          int nfields,
                          const float* g_logf, const float* g_a,
                          const float* g_p, const float* g_r,
                          const float* g_w,
                          const float* s_logf, const float* s_a,
                          const float* s_p, const float* s_r,
                          const float* s_lnom0, const float* s_mask,
                          const int* pieces, int npieces, const int* segs,
                          int nseg, int tile, int fcmin, double* partial,
                          int* tickets, double* out, void* stream) {
    const size_t smem = vg_smem(tile, nseg, FREE_SLOTS);
    if (free_vg_bad(nwalkers, nfeat, nfields, tile, npieces, nseg, smem))
        return (int)cudaErrorInvalidValue;
    const dim3 grid(npieces, (nwalkers + tile - 1) / tile);
    cudaStream_t st = (cudaStream_t)stream;
    switch (tile) {
        case 1: return launch_free_vg<1, FREE_SLOTS>(FREE_VG_ARGS);
        case 2: return launch_free_vg<2, FREE_SLOTS>(FREE_VG_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
}
#undef FREE_VG_ARGS

// n empty kernels of one warp on the stream: the floor under every
// kernel's time in chip_smoke.py's timing harness.
int empty_launch(int n, void* stream) {
    for (int i = 0; i < n; ++i)
        empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

}  // extern "C"
