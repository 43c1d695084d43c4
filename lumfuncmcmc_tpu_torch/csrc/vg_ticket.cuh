// What the one-launch kernels share (lnlike.cu free_lnlike and
// free_lnlike_vg, one body; lnlike_h.cu hier_lnlike, hier_lnlike_vg,
// fixed_lnlike and fixed_lnlike_vg, one body; lnlike_z.cu z_lnlike and
// z_lnlike_vg): the block's reduction of its walkers' sums, the
// per-walker-tile arrival ticket that lets the last block of a tile finish
// it, and the fixed-order segment sums of that finish.
//
// A launch is a (piece, walker tile) grid over a piece table of the host
// (ops/cuda_lnlike.py _vg_tables: each field's cells, or sources, cut into
// near-equal pieces of at most one length; _z_vg_tables: bands of L rows of
// each field's (S_L, S_z) panel, then the sources) and its segment table
// (field, first piece, end piece, is_source): one row for each run of
// pieces of one field and kind. Block (p, t) writes its K double partials
// of each walker of tile t to partial[w][p][:], then draws a ticket of tile
// t. The block that draws the last one sums the tile's partials and writes
// the float64 rows: the sums run in a fixed order (segment by segment,
// lane-strided over the pieces, then a fixed shuffle tree), whichever
// block arrives last, so two launches on one input give the same bits; no
// float atomics.
//
// The tickets live in one int buffer per data object, zeroed once by the
// data preparation (ops/cuda_lnlike.py CudaGridData.vg_tickets,
// CudaZData.vg_tickets); each tile's last block sets its ticket back to 0,
// so the buffer is 0 again when the kernel ends: the next launch, and every
// replay of a CUDA graph that captured the call, finds it so. One data
// object is launched on one stream at a time (the kernels of one stream run
// one after another).

#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>

#include "common.cuh"

__host__ __device__ constexpr int vg_log2_ceil(int v) {
    int s = 0;
    while ((1 << s) < v) ++s;
    return s;
}

// The block's sums of v[0..V) (V <= 32 per-thread sums, float32 or
// double), in double, into res[0..V) in shared memory, valid in every
// thread on return. Each warp reduces and scatters at once: at the step of
// lane offset o (16, 8, ...) every lane keeps half of its values and adds
// the partner's other half, so after log2(V) steps (V padded to a power of
// two) each lane holds one value index and the remaining offsets add it
// across the lanes that share it: ~V double shuffles a warp where a
// shuffle tree per value takes 5 V. Then thread i < V adds value i of the
// eight warps in warp order. A fixed order of additions: the same inputs
// give the same bits.
template <int V, typename F>
__device__ __forceinline__ void vg_block_sums(const F (&v)[V], double* res) {
    static_assert(V >= 1 && V <= 32, "one value per lane at most");
    constexpr int S = vg_log2_ceil(V);      // halving steps
    constexpr int VP = 1 << S;
    __shared__ double red[V][THREADS / 32];
    const int lane = threadIdx.x & 31;
    double x[VP];
#pragma unroll
    for (int i = 0; i < VP; ++i) x[i] = i < V ? (double)v[i] : 0.0;
    int idx = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int half = VP >> (s + 1);     // values kept after this step
        const bool upper = lane & (16 >> s);
#pragma unroll
        for (int i = 0; i < VP / 2; ++i)
            if (i < half) {
                const double send = upper ? x[i] : x[i + half];
                const double keep = upper ? x[i + half] : x[i];
                x[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16 >> s);
            }
        if (upper) idx += half;
    }
#pragma unroll
    for (int o = 16 >> S; o > 0; o >>= 1)
        x[0] += __shfl_xor_sync(0xffffffffu, x[0], o);
    // the first of the 32 / VP lanes that hold each value index
    if (idx < V && (lane & (32 / VP - 1)) == 0)
        red[idx][threadIdx.x >> 5] = x[0];
    __syncthreads();
    if (threadIdx.x < V) {
        double s = 0.0;
#pragma unroll
        for (int w = 0; w < THREADS / 32; ++w) s += red[threadIdx.x][w];
        res[threadIdx.x] = s;
    }
    __syncthreads();
}

// True, in every thread, in the block that drew tile `tile`'s last ticket
// of `nblocks`. Thread 0 has written the block's partials; its ticket is an
// acquire-release add at device scope: the release orders those partials
// before the ticket, the acquire of the last ticket orders every earlier
// block's partials before the last block's reads (after the barrier, and
// taken through L2 by __ldcg in vg_segment_sums).
__device__ __forceinline__ bool vg_last_arrival(int* tickets, int tile,
                                                int nblocks) {
    __shared__ int last;
    if (threadIdx.x == 0) {
        cuda::atomic_ref<int, cuda::thread_scope_device> ticket(
            tickets[tile]);
        last = ticket.fetch_add(1, cuda::memory_order_acq_rel)
            == nblocks - 1;
    }
    __syncthreads();
    return last;
}

// In a tile's last block, with the segment table staged in seg_sh:
// segsum[(j nseg + s) K + k] = the sum over segment s's pieces of
// partial[w0 + j][piece][k] for the tile's nw walkers. Each (walker,
// segment) pair has g lanes (a power of two, g <= 32, as many as let all
// pairs run at once), lane l adding pieces l, l + g, ... of the segment in
// double, then a fixed shuffle tree over the g lanes. Ends with a block
// barrier.
template <int K>
__device__ __forceinline__ void vg_segment_sums(
        const double* __restrict__ partial, int npieces,
        const int4* __restrict__ seg_sh, int nseg, int w0, int nw,
        double* __restrict__ segsum) {
    const int npairs = nw * nseg;
    int g = 32;
    while (g > 1 && g * npairs > THREADS) g >>= 1;
    const int lane = threadIdx.x & (g - 1);
    for (int q0 = 0; q0 < npairs; q0 += THREADS / g) {
        const int q = q0 + threadIdx.x / g;
        double acc[K];
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] = 0.0;
        if (q < npairs) {
            const int j = q / nseg;
            const int4 sg = seg_sh[q - j * nseg];
            const double* pw = partial + (size_t)(w0 + j) * npieces * K;
#pragma unroll 4
            for (int p = sg.y + lane; p < sg.z; p += g)
#pragma unroll
                for (int k = 0; k < K; ++k)
                    acc[k] += __ldcg(pw + (size_t)p * K + k);
        }
        for (int o = g / 2; o > 0; o >>= 1)
#pragma unroll
            for (int k = 0; k < K; ++k)
                acc[k] += __shfl_down_sync(0xffffffffu, acc[k], o);
        if (q < npairs && lane == 0)
#pragma unroll
            for (int k = 0; k < K; ++k) segsum[q * K + k] = acc[k];
    }
    __syncthreads();
}

// Dynamic shared memory of a launch: the staged segment table, then the
// segment sums of T walkers.
__host__ __device__ constexpr size_t vg_smem(int tile, int nseg, int k) {
    return (size_t)nseg * sizeof(int4) + (size_t)tile * nseg * k
        * sizeof(double);
}
