// Streaming free-completeness kernels for mega catalogs (10^5 - 10^6
// sources): free_stream_lnlike replaces the TPU kernel _kernel_free_stream
// (lumfuncmcmc_tpu/ops/pallas_lnlike.py:941, also reached through
// make_stream_shard_batched, :404); free_stream_lnlike_vg replaces
// _kernel_free_stream_vg (:1009, and make_stream_shard_vg, :1711).
//
// What they compute, per walker w (feature row th = feats[w], the layout of
// ops/cuda_lnlike.py _features_stream: logf and lF50 relative to
// logf_ref = -16), for one shard of the sources:
//     sum over source tiles    sum_src  mask ln fc(logf; ac, lF50_f, t2_f)
//   - sum over grid chunks     sum_cell exp(c_g + aA (a - lA) - P t1 + ln fc) w
// with the grid weights already divided by the shard count. The
// theta-affine source terms (ln phi's N c_s + aA sum(a - lA) - t1 sum P and
// sum ln Omega0) are not here: the host adds them in float64 from float64
// catalog sums (ops/cuda_lnlike.py _stream_collapsed). At 10^6 sources
// |lnL| ~ 1.5e7, where float32's spacing is ~1 and the sampler's accept
// step needs differences good to << 1, so the value leaves in float64.
// The _vg kernel emits [lnl, d_cg, d_cs (= 0 here), d_aA, d_lA, d_t1, d_ac,
// d_lf50_f.., d_t2_f..], the column order of _kernel_free_stream_vg.
//
// What bounds them on the card: instruction issue on the transcendental
// chain. A (source, walker) pair costs rsqrt, a software logf, an expf and
// an IEEE divide (fcmin set): ~62 SASS instructions, 3 of them MUFU
// (cuobjdump -sass of stream_partials' source loop, 4 walkers per
// iteration); a grid cell one exp more. At 10^6 sources and W = 50 that is
// 5e7 pairs, ~3.2e9 instructions, ~100 us of issue on 132 SMs, against
// 12 MB of source arrays (logf, R, mask: the collapse leaves those) that a
// call reads once. The first design of these kernels added, per pair, a
// float-to-double conversion and a double add, and read the sources
// ceil(W / 4) times from L2 in blocks of 2,048 x 4 pairs. This design:
//   - runs: the host's run table (field, start, end, is_source) cuts each
//     field's padded source tiles (2048 sources) into runs of up to
//     run_pieces tiles, the fewest that let the runs fill half of one
//     wave of the value kernel (its occupancy from
//     free_stream_blocks_per_sm, queried on the card); a grid run is up
//     to run_pieces x 2048 cells of one field. Block (run, group) owns
//     one run; nothing crosses a field, so lF50_f and t2_f are per-block
//     constants;
//   - asynchronous staging: at its start a block copies its source run
//     (logf, R, mask: 24 KB a tile) into shared memory with bulk
//     asynchronous copies (cp.async.bulk, the 1-D form of the Tensor
//     Memory Accelerator), each quarter tile completing on its own
//     mbarrier, so the first quarter computes while the rest lands;
//   - every walker against a staged run: the block walks the walker tiles
//     (WT = 4 walkers; their features staged in shared memory, then held
//     in registers) of its group against the resident run. Groups split
//     the walkers only as far as the runs leave room in that wave, so
//     each source is read from memory once per group;
//   - float32 sums, compensated: each thread sums a tile's terms for each
//     walker (8 at 256 threads) in plain float32, then adds that into a
//     Kahan-compensated float32 sum over the run, converted to double once
//     at the end of the walker tile: one float add per pair where the
//     first design spent a conversion and a double add;
//   - one reduction per walker tile and run: the block reduces its WT
//     compensated sums (value, in double) and, for _vg, its WT x 5 float
//     gradient sums into a (W, runs, K) double buffer, no atomics;
//   - one-pass finishes: the value finish sums each walker's run partials
//     in a fixed order (strided, then a fixed tree); the _vg finish reads
//     each partial row once, adds it into every column it feeds (each
//     thread its own column slots in shared memory), and sums all columns
//     in one tree (the first design swept them once per column). Identical
//     results run to run.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): W = 50 ~152 us
// against the first design's 165 us, W = 8 (_vg) ~48 us against 66.7 us;
// at full issue the pair's own arithmetic would take ~2/3 of the time.
// Tried and left: walker tiles of 2 and 8, runs of 1, 3 and 4 tiles, a 2x
// source unroll.
// No tensor cores: each (source or cell, walker) term is nonlinear in that
// walker's features (log, rsqrt, exp of a feature-dependent argument); the
// only products are the _vg slots' sum_i E_wi [a_i, P_i, 1], N = 3, below
// wgmma's N >= 8, and TF32's 10-bit mantissa would fail the 2e-3 gradient
// gate. Plain expf/logf/rsqrtf (no --use_fast_math), matching the plain
// PyTorch versions in ops/cuda_lnlike.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

#define STREAM_SLOTS 6   // ops/cuda_lnlike.py VG_STREAM_SLOTS
#define WFEAT 7          // per walker: c_g, aA, lA, t1, ac, lF50_f, t2_f
#define PIECE 2048       // ops/cuda_lnlike.py CHUNK_CELLS: one source tile
#define MAX_RUN 4        // ops/cuda_lnlike.py STREAM_MAX_RUN
#define SUB 512          // sources per mbarrier (a quarter of a tile)
#define MAX_SUBS (MAX_RUN * PIECE / SUB)
#define FIN_THREADS 128  // stream_vg_finish's block
#define WT 4             // walkers per tile

// ---------------------------------------------------------------------------
// bulk asynchronous copies into shared memory, completing on mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// Thread 0 starts the copies of the source run [start, start + n) (n a
// multiple of PIECE, start PIECE-aligned) into staged = [logf | R | mask],
// each quarter tile on its own mbarrier; bar[k] completes when sources
// [k SUB, (k + 1) SUB) of the run are in.
__device__ __forceinline__ void stage_run(float* staged, uint64_t* bar,
                                          const float* __restrict__ s_logf,
                                          const float* __restrict__ s_r,
                                          const float* __restrict__ s_mask,
                                          int start, int n) {
    const int nsub = n / SUB;
    if (threadIdx.x == 0) {
        for (int k = 0; k < nsub; ++k) mbar_init(&bar[k], 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        const uint32_t bytes = SUB * sizeof(float);
        for (int p = 0; p < nsub; ++p) {
            const int off = p * SUB;
            mbar_expect_tx(&bar[p], 3 * bytes);
            bulk_load(staged + off, s_logf + start + off, bytes, &bar[p]);
            bulk_load(staged + n + off, s_r + start + off, bytes, &bar[p]);
            bulk_load(staged + 2 * n + off, s_mask + start + off, bytes,
                      &bar[p]);
        }
    }
}

// ---------------------------------------------------------------------------
// partial kernels
// ---------------------------------------------------------------------------

// Stage the tile's walkers' features (for this block's field) in shared
// memory; rows past the last walker repeat the tile's first row, so every
// thread runs the same WT-wide loop and only the write is guarded.
__device__ __forceinline__ int stage_walkers(float (&sh)[WT][WFEAT],
                                             const float* __restrict__ feats,
                                             int nwalkers, int nfeat,
                                             int nfields, int w0, int field) {
    const int nw = min(WT, nwalkers - w0);
    if (threadIdx.x < WT) {
        const int w = w0 + (threadIdx.x < nw ? threadIdx.x : 0);
        const float* th = feats + (size_t)w * nfeat;
        float* s = sh[threadIdx.x];
        s[0] = th[0];
        s[1] = th[2];
        s[2] = th[3];
        s[3] = th[4];
        s[4] = th[5];
        s[5] = th[6 + field];
        s[6] = th[6 + nfields + field];
    }
    __syncthreads();
    return nw;
}

__global__ void __launch_bounds__(THREADS)
stream_partials(const float* __restrict__ feats, int nwalkers, int nfeat,
                int nfields,
                const float* __restrict__ g_logf, const float* __restrict__ g_a,
                const float* __restrict__ g_p, const float* __restrict__ g_r,
                const float* __restrict__ g_w,
                const float* __restrict__ s_logf,
                const float* __restrict__ s_r,
                const float* __restrict__ s_mask,
                const int4* __restrict__ runs, int nruns, int fcmin,
                double* __restrict__ partial) {
    extern __shared__ __align__(16) float staged[];
    __shared__ __align__(8) uint64_t bar[MAX_SUBS];
    __shared__ float sh[WT][WFEAT];
    const int run = blockIdx.x;
    const int4 rn = runs[run];            // (field, start, end, is_source)
    const int n = rn.z - rn.y;
    const int ntiles = (nwalkers + WT - 1) / WT;
    if (rn.w) stage_run(staged, bar, s_logf, s_r, s_mask, rn.y, n);
    bool first = true;
    for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
        const int w0 = tile * WT;
        const int nw = stage_walkers(sh, feats, nwalkers, nfeat, nfields, w0,
                                     rn.x);
        float s[WT], c[WT], th[WT][WFEAT];   // the tile's features, held
#pragma unroll                               // in registers across the
        for (int j = 0; j < WT; ++j) {       // loop's barrier waits
            s[j] = c[j] = 0.0f;
#pragma unroll
            for (int k = 0; k < WFEAT; ++k) th[j][k] = sh[j][k];
        }
        if (!rn.w) {
            for (int i = rn.y + threadIdx.x; i < rn.z; i += THREADS) {
                const float lf = g_logf[i], a = g_a[i], p = g_p[i];
                const float r = g_r[i], wgt = g_w[i];
#pragma unroll
                for (int j = 0; j < WT; ++j) {
                    const float e = th[j][0] + th[j][1] * (a - th[j][2])
                        - p * th[j][3]
                        + ln_fc(lf, r, th[j][4], th[j][5], th[j][6], fcmin);
                    kahan_add(s[j], c[j], -(expf(e) * wgt));
                }
            }
        } else {
            const float* lfs = staged;
            const float* rs = staged + n;
            const float* ms = staged + 2 * n;
            // a tile's 8 terms per thread in plain float32, then one
            // compensated add per tile
            for (int p0 = 0; p0 < n; p0 += PIECE) {
                float part[WT];
#pragma unroll
                for (int j = 0; j < WT; ++j) part[j] = 0.0f;
                for (int q = p0; q < p0 + PIECE; q += SUB) {
                    if (first) mbar_wait(&bar[q / SUB], 0);
                    for (int i = q + threadIdx.x; i < q + SUB; i += THREADS) {
                        if (ms[i] > 0.0f) {
                            const float lf = lfs[i], r = rs[i];
#pragma unroll
                            for (int j = 0; j < WT; ++j)
                                part[j] += ln_fc(lf, r, th[j][4], th[j][5],
                                                 th[j][6], fcmin);
                        }
                    }
                }
#pragma unroll
                for (int j = 0; j < WT; ++j) kahan_add(s[j], c[j], part[j]);
            }
            first = false;
        }
        double v[WT];
#pragma unroll
        for (int j = 0; j < WT; ++j) v[j] = (double)s[j] - (double)c[j];
        block_sum_k<WT>(v);
        if (threadIdx.x == 0)
            for (int j = 0; j < nw; ++j)
                partial[(size_t)(w0 + j) * nruns + run] = v[j];
    }
}

// Grid run slots:   [Se, Se*am, Se*P, Se*dfx*dl, Se*dfx, Se*dft]
// Source run slots: [S lnfc, Sm*dfx*dl, Sm*dfx, Sm*dft, -, -]
// with am = a - lA, dl = logf - lF50_f, S over the run's cells; slot 0 (the
// value, and -d_cg) compensated and reduced in double, the others in float.
__global__ void __launch_bounds__(THREADS)
stream_vg_partials(const float* __restrict__ feats, int nwalkers, int nfeat,
                   int nfields,
                   const float* __restrict__ g_logf,
                   const float* __restrict__ g_a,
                   const float* __restrict__ g_p,
                   const float* __restrict__ g_r,
                   const float* __restrict__ g_w,
                   const float* __restrict__ s_logf,
                   const float* __restrict__ s_r,
                   const float* __restrict__ s_mask,
                   const int4* __restrict__ runs, int nruns, int fcmin,
                   double* __restrict__ partial) {
    constexpr int G = STREAM_SLOTS - 1;     // float slots per walker
    extern __shared__ __align__(16) float staged[];
    __shared__ __align__(8) uint64_t bar[MAX_SUBS];
    __shared__ float sh[WT][WFEAT];
    const int run = blockIdx.x;
    const int4 rn = runs[run];
    const int n = rn.z - rn.y;
    const int ntiles = (nwalkers + WT - 1) / WT;
    if (rn.w) stage_run(staged, bar, s_logf, s_r, s_mask, rn.y, n);
    bool first = true;
    for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
        const int w0 = tile * WT;
        const int nw = stage_walkers(sh, feats, nwalkers, nfeat, nfields, w0,
                                     rn.x);
        float s[WT], c[WT], acc[WT * G], th[WT][WFEAT];
#pragma unroll
        for (int j = 0; j < WT; ++j) {
            s[j] = c[j] = 0.0f;
#pragma unroll
            for (int k = 0; k < WFEAT; ++k) th[j][k] = sh[j][k];
        }
#pragma unroll
        for (int k = 0; k < WT * G; ++k) acc[k] = 0.0f;
        if (!rn.w) {
            for (int i = rn.y + threadIdx.x; i < rn.z; i += THREADS) {
                const float lf = g_logf[i], a = g_a[i], p = g_p[i];
                const float r = g_r[i], wgt = g_w[i];
#pragma unroll
                for (int j = 0; j < WT; ++j) {
                    const FcTerms t = fc_terms(lf, r, th[j][4], th[j][5],
                                               th[j][6], fcmin);
                    const float am = a - th[j][2];
                    const float e = expf(th[j][0] + th[j][1] * am
                                         - p * th[j][3] + t.lnfc) * wgt;
                    const float edfx = e * t.dfx;
                    float* g = acc + j * G;
                    kahan_add(s[j], c[j], e);
                    g[0] += e * am;
                    g[1] += e * p;
                    g[2] += edfx * (lf - th[j][5]);
                    g[3] += edfx;
                    g[4] += e * t.dft;
                }
            }
        } else {
            const float* lfs = staged;
            const float* rs = staged + n;
            const float* ms = staged + 2 * n;
            for (int p0 = 0; p0 < n; p0 += PIECE) {
                float part[WT];
#pragma unroll
                for (int j = 0; j < WT; ++j) part[j] = 0.0f;
                for (int q = p0; q < p0 + PIECE; q += SUB) {
                    if (first) mbar_wait(&bar[q / SUB], 0);
                    for (int i = q + threadIdx.x; i < q + SUB; i += THREADS) {
                        const float m = ms[i];
                        if (m > 0.0f) {
                            const float lf = lfs[i], r = rs[i];
#pragma unroll
                            for (int j = 0; j < WT; ++j) {
                                const FcTerms t = fc_terms(
                                    lf, r, th[j][4], th[j][5], th[j][6],
                                    fcmin);
                                const float mdfx = m * t.dfx;
                                float* g = acc + j * G;
                                part[j] += m * t.lnfc;
                                g[0] += mdfx * (lf - th[j][5]);
                                g[1] += mdfx;
                                g[2] += m * t.dft;
                            }
                        }
                    }
                }
#pragma unroll
                for (int j = 0; j < WT; ++j) kahan_add(s[j], c[j], part[j]);
            }
            first = false;
        }
        double v[WT];
#pragma unroll
        for (int j = 0; j < WT; ++j) v[j] = (double)s[j] - (double)c[j];
        block_sum_k<WT>(v);
        block_sum_k<WT * G>(acc);
        if (threadIdx.x == 0)
            for (int j = 0; j < nw; ++j) {
                double* out = partial + ((size_t)(w0 + j) * nruns + run)
                    * STREAM_SLOTS;
                out[0] = v[j];
#pragma unroll
                for (int k = 0; k < G; ++k) out[1 + k] = acc[j * G + k];
            }
    }
}

// ---------------------------------------------------------------------------
// finishes
// ---------------------------------------------------------------------------

// Block w: out[w] = sum_r partial[w, r] in double: strided per thread, then
// a fixed tree.
__global__ void __launch_bounds__(THREADS)
stream_finish(const double* __restrict__ partial, int nruns,
              double* __restrict__ out) {
    __shared__ double red[THREADS];
    const double* p = partial + (size_t)blockIdx.x * nruns;
    double s = 0.0;
    for (int r = threadIdx.x; r < nruns; r += THREADS) s += p[r];
    red[threadIdx.x] = s;
    for (int o = THREADS / 2; o > 0; o >>= 1) {
        __syncthreads();
        if (threadIdx.x < o) red[threadIdx.x] += red[threadIdx.x + o];
    }
    if (threadIdx.x == 0) out[blockIdx.x] = red[0];
}

// Block w, in one pass: thread t reads the partial rows of runs t,
// t + FIN_THREADS, ... once each and adds every slot into the columns it
// feeds, in the thread's own slots acc[col][t] of shared memory (a source
// run's d_lf50/d_t2 terms into its field's columns); then one fixed tree
// over t sums all 1 + nfeat columns together, and thread col writes column
// col times its multiplier (aA for d_lA, ac for d_lf50_f).
__global__ void __launch_bounds__(FIN_THREADS)
stream_vg_finish(const double* __restrict__ partial,
                 const int4* __restrict__ runs, int nruns,
                 const float* __restrict__ feats, int nfeat, int nfields,
                 double* __restrict__ out) {
    extern __shared__ double acc[];     // [1 + nfeat][FIN_THREADS]
    const int w = blockIdx.x;
    const int t = threadIdx.x;
    const int ncols = 1 + nfeat;
    for (int col = 0; col < ncols; ++col) acc[col * FIN_THREADS + t] = 0.0;
    double* a = acc + t;
    const double* pw = partial + (size_t)w * nruns * STREAM_SLOTS;
    for (int r = t; r < nruns; r += FIN_THREADS) {
        const int4 rn = runs[r];
        const double* v = pw + (size_t)r * STREAM_SLOTS;
        double* lf50 = a + (7 + rn.x) * FIN_THREADS;
        double* t2 = a + (7 + nfields + rn.x) * FIN_THREADS;
        if (rn.w) {
            a[0] += v[0];                       // lnl
            a[6 * FIN_THREADS] += v[1];         // d_ac
            *lf50 -= v[2];
            *t2 += v[3];
        } else {
            a[0] -= v[0];                       // lnl
            a[1 * FIN_THREADS] -= v[0];         // d_cg
            a[3 * FIN_THREADS] -= v[1];         // d_aA
            a[4 * FIN_THREADS] += v[0];         // d_lA / aA
            a[5 * FIN_THREADS] += v[2];         // d_t1
            a[6 * FIN_THREADS] -= v[3];         // d_ac
            *lf50 += v[4];
            *t2 -= v[5];
        }
    }
    for (int o = FIN_THREADS / 2; o > 0; o >>= 1) {
        __syncthreads();
        if (t < o)
            for (int col = 0; col < ncols; ++col)
                acc[col * FIN_THREADS + t] += acc[col * FIN_THREADS + t + o];
    }
    __syncthreads();
    for (int col = t; col < ncols; col += FIN_THREADS) {
        const float* th = feats + (size_t)w * nfeat;
        const double m = col == 4 ? (double)th[2]
            : (col >= 7 && col < 7 + nfields ? (double)th[5] : 1.0);
        out[(size_t)w * ncols + col] = m * acc[col * FIN_THREADS];
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The kernels' shared-memory opt-in, on the current device, to the
// longest run any table may ask for (so a table of short runs never lowers
// it for a later one). Set at every launch, and before every occupancy
// query, so each card has its own and nothing is cached here.
template <typename K>
static cudaError_t opt_in(K kernel) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                3 * MAX_RUN * PIECE * (int)sizeof(float));
}

// Walker groups of a (runs, groups) grid: as many as the runs leave room
// for in one wave of `wave` blocks (a partial second wave would leave most
// SMs idle for its length), at most one per walker tile.
static int walker_groups(int wave, int nruns, int nwalkers) {
    const int ntiles = (nwalkers + WT - 1) / WT;
    return max(1, min(ntiles, wave / nruns));
}

extern "C" {

// Blocks of free_stream_lnlike's (vg = 0) or free_stream_lnlike_vg's
// (vg = 1) partial kernel that one SM of the current device holds at once,
// for runs of run_pieces tiles, into *blocks; returns the cudaError_t.
// ops/cuda_lnlike.py sizes the run table and the wave from this.
int free_stream_blocks_per_sm(int vg, int run_pieces, int* blocks) {
    if (run_pieces < 1 || run_pieces > MAX_RUN)
        return (int)cudaErrorInvalidValue;
    const int smem = 3 * run_pieces * PIECE * (int)sizeof(float);
    cudaError_t e = vg ? opt_in(stream_vg_partials) : opt_in(stream_partials);
    if (e != cudaSuccess) return (int)e;
    return vg ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks, stream_vg_partials, THREADS, smem)
              : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks, stream_partials, THREADS, smem);
}

// All pointers are device pointers (the source arrays those of one shard);
// the stream is a cudaStream_t. runs is the (nruns, 4) int32 run table,
// each source run at most run_pieces tiles; wave is the number of blocks
// of the partial kernel that fill the card once (free_stream_blocks_per_sm
// times the SM count). Returns the cudaError_t of the launches (0 =
// success). Allocates nothing: the caller passes a (W, nruns, K) double
// partial buffer (K = 1, or STREAM_SLOTS for the _vg kernel) and the double
// output, (W,) or (W, 1 + nfeat).
int free_stream_lnlike_launch(const float* feats, int nwalkers, int nfeat,
                              int nfields,
                              const float* g_logf, const float* g_a,
                              const float* g_p, const float* g_r,
                              const float* g_w,
                              const float* s_logf, const float* s_r,
                              const float* s_mask,
                              const int* runs, int nruns, int run_pieces,
                              int wave, int fcmin, double* partial,
                              double* out, void* stream) {
    if (nfeat != 6 + 2 * nfields || run_pieces < 1 || run_pieces > MAX_RUN)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int smem = 3 * run_pieces * PIECE * (int)sizeof(float);
    cudaError_t e = opt_in(stream_partials);
    if (e != cudaSuccess) return (int)e;
    const int groups = walker_groups(wave, nruns, nwalkers);
    stream_partials<<<dim3(nruns, groups), THREADS, smem, st>>>(
        feats, nwalkers, nfeat, nfields, g_logf, g_a, g_p, g_r, g_w,
        s_logf, s_r, s_mask, (const int4*)runs, nruns, fcmin, partial);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    stream_finish<<<nwalkers, THREADS, 0, st>>>(partial, nruns, out);
    return (int)cudaGetLastError();
}

int free_stream_lnlike_vg_launch(const float* feats, int nwalkers, int nfeat,
                                 int nfields,
                                 const float* g_logf, const float* g_a,
                                 const float* g_p, const float* g_r,
                                 const float* g_w,
                                 const float* s_logf, const float* s_r,
                                 const float* s_mask,
                                 const int* runs, int nruns, int run_pieces,
                                 int wave, int fcmin, double* partial,
                                 double* out, void* stream) {
    const int ncols = 1 + nfeat;
    const int fin_smem = ncols * FIN_THREADS * (int)sizeof(double);
    if (nfeat != 6 + 2 * nfields || run_pieces < 1 || run_pieces > MAX_RUN
        || fin_smem > 227 * 1024)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int smem = 3 * run_pieces * PIECE * (int)sizeof(float);
    cudaError_t e = opt_in(stream_vg_partials);
    if (e != cudaSuccess) return (int)e;
    const int groups = walker_groups(wave, nruns, nwalkers);
    stream_vg_partials<<<dim3(nruns, groups), THREADS, smem, st>>>(
        feats, nwalkers, nfeat, nfields, g_logf, g_a, g_p, g_r, g_w,
        s_logf, s_r, s_mask, (const int4*)runs, nruns, fcmin, partial);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (fin_smem > 40 * 1024) {
        e = cudaFuncSetAttribute(stream_vg_finish,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 fin_smem);
        if (e != cudaSuccess) return (int)e;
    }
    stream_vg_finish<<<nwalkers, FIN_THREADS, fin_smem, st>>>(
        partial, (const int4*)runs, nruns, feats, nfeat, nfields, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
