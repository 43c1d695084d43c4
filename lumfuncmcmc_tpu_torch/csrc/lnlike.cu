// Single-epoch log-likelihood kernels for Hopper (sm_90a): the value
// kernels and their value + feature-gradient twins (the NUTS gradient
// path). The z model's kernels are in lnlike_z.cu; the sources share
// common.cuh (block size, block reduction, the ln fc terms, the value
// kernels' finish pass) and are compiled into one library by ops/_build.py;
// free_lnlike_vg shares vg_ticket.cuh (the one-launch finish) with
// hier_lnlike_vg and z_lnlike_vg.
//
// free_lnlike replaces the TPU kernels _kernel_free_bcast
// (lumfuncmcmc_tpu/ops/pallas_lnlike.py:601) and _kernel_free (:761);
// fixed_lnlike replaces _kernel_fixed_bcast (:751) and _kernel_fixed
// (:813). The TPU's broadcast/slab variants are two VMEM layouts of one
// computation; here one layout serves every catalog size.
// free_lnlike_vg replaces _kernel_free_vg (:832). fixed_lnlike_vg, which
// replaces _kernel_fixed_vg (:1255), is hier_lnlike_vg's kernel body with
// the features shared by every field, in lnlike_h.cu; its rows are
// described here.
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
// call is ~2.6 M cell evaluations: a few microseconds of SFU work, with
// the grid arrays (1 MB) resident in L2 across walkers. At the NUTS shape
// (W = 8 chains) a value+gradient call is ~0.4 M cell evaluations of ~50
// float32 operations each, a fraction of a microsecond at the card's peak
// rates: launch latency and the dependent transcendental chain per thread
// bound it; at W = 256 the SFU rate takes over. The value kernels keep
// the SMs busy at small W and stay deterministic:
//   - grid (nchunks, W): block (c, w) reduces chunk c (<= 2048 cells or
//     sources of one field, from the host chunk table (field, start, end,
//     is_source)) for walker w, so W = 50 already gives ~1,500 blocks for
//     132 SMs;
//   - each thread accumulates its few terms in a float32 register, the
//     block reduces the sums in double with warp shuffles and one
//     shared-memory pass, and writes them to a (W, nchunks) double
//     scratch buffer the caller allocates;
//   - a second small kernel sums each walker's partials in fixed chunk
//     order (in double) and writes float64: no float atomics, identical
//     results run to run.
// free_lnlike_vg was built so too, and its finish pass alone took 7.4-8.2
// us a call whatever W (a 32-thread block per walker walking its 30 chunk
// partials), more than its partial pass at W = 1 and 8 (6.0-6.7 us), with
// a second launch (~1.1 us) on top; at W = 256 the partial pass took 80
// us, 2.2x the same-mix bound (PERF.md, H100 80GB HBM3). It is now one
// launch a call, the same rows:
//   - a (piece, walker tile) grid: the host cuts every field's cells and
//     sources into near-equal pieces of one length and picks the length
//     and the tile (1 or 2 walkers: tiles of 4 held 99 registers, 2 blocks
//     an SM, and ran slower) from W and the SM count (ops/cuda_lnlike.py
//     _vg_geometry): at W = 1 pieces of 512 (105 blocks), at W = 8 of 2048
//     (240), at W = 256 tiles of 2 walkers on pieces of ~3400 cells (2560
//     blocks), so a cell is read once per tile and a thread runs two
//     independent chains;
//   - each thread loads its next cell before it computes this one;
//   - the block reduces its T x 7 float32 sums in double by a
//     reduce-scatter over the lanes (vg_ticket.cuh vg_block_sums: ~T x 7
//     double shuffles a warp, where a shuffle tree per sum takes five times
//     that), writes its partials and draws its tile's ticket; the last
//     block of the tile sums the tile's partials per segment in a fixed
//     order, routes each segment's slots to its columns (d_lf50/d_t2 to
//     the segment's field) and writes float64 (vg_ticket.cuh): one kernel
//     node per call, no float atomics, the same bits run to run, and the
//     cancellation of d_cg + d_cs (~ -integral + N near the mode) happens
//     in double.
// Plain expf/logf/rsqrtf (no --use_fast_math), matching the plain PyTorch
// versions in ops/cuda_lnlike.py.

#include <cuda_runtime.h>

#include "common.cuh"
#include "vg_ticket.cuh"

#define FREE_SLOTS 7     // ops/cuda_lnlike.py VG_FREE_SLOTS

// ---------------------------------------------------------------------------
// value kernels
// ---------------------------------------------------------------------------

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
              double* __restrict__ partial) {
    const int c = blockIdx.x;
    const int w = blockIdx.y;
    const int4 ch = chunks[c];            // (field, start, end, is_source)
    const float* th = feats + (size_t)w * nfeat;
    const float aA = th[2], lA = th[3], t1 = th[4], ac = th[5];
    const float lf50 = th[6 + ch.x];
    const float t2 = th[6 + nfields + ch.x];
    float acc[1] = {0.0f};
    if (!ch.w) {
        const float c_g = th[0];
        for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS) {
            const float e = c_g + aA * (g_a[i] - lA) - g_p[i] * t1
                + ln_fc(g_logf[i], g_r[i], ac, lf50, t2, fcmin);
            acc[0] -= expf(e) * g_w[i];
        }
    } else {
        const float c_s = th[1];
        for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS) {
            if (s_mask[i] > 0.0f) {
                acc[0] += c_s + aA * (s_a[i] - lA) - s_p[i] * t1 + s_lnom0[i]
                    + ln_fc(s_logf[i], s_r[i], ac, lf50, t2, fcmin);
            }
        }
    }
    const double s = block_sum_f32_to_f64(acc[0]);
    if (threadIdx.x == 0) partial[(size_t)w * nchunks + c] = s;
}

__global__ void __launch_bounds__(THREADS)
fixed_partials(const float* __restrict__ feats, int nfeat,
               const float* __restrict__ g_a, const float* __restrict__ g_p,
               const float* __restrict__ g_w,
               const int4* __restrict__ chunks, int nchunks,
               double* __restrict__ partial) {
    const int c = blockIdx.x;
    const int w = blockIdx.y;
    const int4 ch = chunks[c];
    const float* th = feats + (size_t)w * nfeat;
    const float cg = th[0], aA = th[1], lA = th[2], t1 = th[3];
    float acc[1] = {0.0f};
    for (int i = ch.y + threadIdx.x; i < ch.z; i += THREADS)
        acc[0] -= expf(cg + aA * (g_a[i] - lA) - g_p[i] * t1) * g_w[i];
    const double s = block_sum_f32_to_f64(acc[0]);
    if (threadIdx.x == 0) partial[(size_t)w * nchunks + c] = s;
}

// ---------------------------------------------------------------------------
// value + gradient kernels
// ---------------------------------------------------------------------------

// free_lnlike_vg: one kernel per call. Block (p, t) of a (piece, walker
// tile) grid runs piece p of the host's piece table (vg_ticket.cuh) for the
// T walkers of tile t: each thread takes one cell (or source) a loop trip,
// the next trip's loaded before this one's is computed, and evaluates it
// against every walker of the tile from registers, so a trip holds T
// independent rsqrt -> logf -> divide -> expf chains and each cell is read
// once per tile, not once per walker.
// Grid piece slots:   [Se, Se*am, Se*P, Se*dfx*dl, Se*dfx, Se*dft, 0]
// Source piece slots: [Scontrib, Sm, Sm*am, Sm*P, Sm*dfx*dl, Sm*dfx, Sm*dft]
// with am = a - lA, dl = logf - lF50_f, S over the piece's cells, per
// walker; float32 per thread, then the block's double reduction into the
// (W, npieces, FREE_SLOTS) double partials. The tile's last block to draw
// its ticket sums them per segment in a fixed order and routes each
// segment's slots to the columns of the row, [lnl, d_cg, d_cs, d_aA, d_lA,
// d_t1, d_ac, d_lf50_f.., d_t2_f..]: each column takes one slot of a grid
// segment and one of a source segment, times a multiplier (0: no term),
// the per-field columns only their field's segments.
template <int T>
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
    float acc[T * FREE_SLOTS];
#pragma unroll
    for (int k = 0; k < T * FREE_SLOTS; ++k) acc[k] = 0.0f;
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
                const FcTerms t = fc_terms(lf, r, ac[j], lf50[j], t2[j],
                                           fcmin);
                const float am = a - lA[j];
                const float e = expf(c0[j] + aA[j] * am - p * t1[j]
                                     + t.lnfc) * wg;
                const float edfx = e * t.dfx;
                float* g = acc + j * FREE_SLOTS;
                g[0] += e;
                g[1] += e * am;
                g[2] += e * p;
                g[3] += edfx * (lf - lf50[j]);
                g[4] += edfx;
                g[5] += e * t.dft;
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
                    const FcTerms t = fc_terms(lf, r, ac[j], lf50[j], t2[j],
                                               fcmin);
                    const float am = a - lA[j];
                    const float mdfx = m * t.dfx;
                    float* g = acc + j * FREE_SLOTS;
                    g[0] += c0[j] + aA[j] * am - p * t1[j] + om + t.lnfc;
                    g[1] += m;
                    g[2] += m * am;
                    g[3] += m * p;
                    g[4] += mdfx * (lf - lf50[j]);
                    g[5] += mdfx;
                    g[6] += m * t.dft;
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
    __shared__ double res[T * FREE_SLOTS];
    vg_block_sums<T * FREE_SLOTS>(acc, res);
    const int npieces = gridDim.x;
    if (threadIdx.x == 0)
        for (int j = 0; j < nw; ++j) {
            double* o = partial + ((size_t)(w0 + j) * npieces + blockIdx.x)
                * FREE_SLOTS;
#pragma unroll
            for (int k = 0; k < FREE_SLOTS; ++k)
                o[k] = res[j * FREE_SLOTS + k];
        }
    if (!vg_last_arrival(tickets, blockIdx.y, npieces)) return;

    // the tile's last block: its rows
    vg_segment_sums<FREE_SLOTS>(partial, npieces, seg_sh, nseg, w0, nw,
                                segsum);
    const int ncols = 1 + nfeat;
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
        const double* ss = segsum + (size_t)j * nseg * FREE_SLOTS;
        double s = 0.0;
        for (int q = 0; q < nseg; ++q) {
            const int4 sg = seg_sh[q];
            const double m = sg.w ? sm : gm;
            if (m != 0.0 && (field < 0 || sg.x == field))
                s += m * ss[q * FREE_SLOTS + (sg.w ? sk : gk)];
        }
        out[(size_t)(w0 + j) * ncols + col] = s;
    }
    if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
}

template <int T>
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
            free_vg<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    free_vg<T><<<grid, THREADS, smem, st>>>(
        feats, nwalkers, nfeat, nfields, g_logf, g_a, g_p, g_r, g_w, s_logf,
        s_a, s_p, s_r, s_lnom0, s_mask, (const int4*)pieces,
        (const int4*)segs, nseg, fcmin, partial, tickets, out);
    return (int)cudaGetLastError();
}

static __global__ void empty_kernel() {}

extern "C" {

// All pointers are device pointers; the stream is a cudaStream_t. Returns
// the cudaError_t of the launches (0 = success). Allocates nothing: the
// caller passes a (W, nchunks) double partial buffer (free_lnlike_vg's
// below) and the double output, (W,) or (W, 1 + nfeat).
int free_lnlike_launch(const float* feats, int nwalkers, int nfeat,
                       int nfields,
                       const float* g_logf, const float* g_a,
                       const float* g_p, const float* g_r, const float* g_w,
                       const float* s_logf, const float* s_a,
                       const float* s_p, const float* s_r,
                       const float* s_lnom0, const float* s_mask,
                       const int* chunks, int nchunks, int fcmin,
                       double* partial, double* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid(nchunks, nwalkers);
    free_partials<<<grid, THREADS, 0, st>>>(
        feats, nfeat, nfields, g_logf, g_a, g_p, g_r, g_w, s_logf, s_a, s_p,
        s_r, s_lnom0, s_mask, (const int4*)chunks, nchunks, fcmin, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    finish<<<(nwalkers + 127) / 128, 128, 0, st>>>(partial, nchunks,
                                                   nwalkers, out);
    return (int)cudaGetLastError();
}

int fixed_lnlike_launch(const float* feats, int nwalkers, int nfeat,
                        const float* g_a, const float* g_p, const float* g_w,
                        const int* chunks, int nchunks,
                        double* partial, double* out, void* stream) {
    if (nfeat != 4) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid(nchunks, nwalkers);
    fixed_partials<<<grid, THREADS, 0, st>>>(
        feats, nfeat, g_a, g_p, g_w, (const int4*)chunks, nchunks, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    finish<<<(nwalkers + 127) / 128, 128, 0, st>>>(partial, nchunks,
                                                   nwalkers, out);
    return (int)cudaGetLastError();
}

// free_lnlike_vg: pieces is the (npieces, 4) piece table and segs the
// (nseg, 4) segment table of one piece length (ops/cuda_lnlike.py
// _vg_tables), tile the walker tile (_vg_geometry: 1 or 2), partial a
// (W, npieces, FREE_SLOTS) double buffer, tickets the data's zeroed ticket
// buffer of at least ceil(W / tile) ints, out (W, 1 + nfeat) double. One
// launch.
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
    if (nfeat != 6 + 2 * nfields || nwalkers < 1 || tile < 1
        || npieces < 1 || nseg < 1 || nseg > npieces
        || (nwalkers + tile - 1) / tile > 65535 || smem > 227 * 1024)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(npieces, (nwalkers + tile - 1) / tile);
    cudaStream_t st = (cudaStream_t)stream;
#define FREE_VG_ARGS grid, smem, st, feats, nwalkers, nfeat, nfields, \
        g_logf, g_a, g_p, g_r, g_w, s_logf, s_a, s_p, s_r, s_lnom0, s_mask, \
        pieces, segs, nseg, fcmin, partial, tickets, out
    switch (tile) {
        case 1: return launch_free_vg<1>(FREE_VG_ARGS);
        case 2: return launch_free_vg<2>(FREE_VG_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef FREE_VG_ARGS
}

// n empty kernels of one warp on the stream: the floor under every
// kernel's time in chip_smoke.py's timing harness.
int empty_launch(int n, void* stream) {
    for (int i = 0; i < n; ++i)
        empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

}  // extern "C"
