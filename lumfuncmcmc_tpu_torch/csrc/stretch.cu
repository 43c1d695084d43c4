// The stretch move's half-step on Hopper (sm_90a): the proposal
// (stretch_propose) and the accept step (stretch_accept), one launch each,
// around the lnprob call, which stays in Python between them (the wrappers
// of ops/stretch.py, which samplers/affine.py _half_step calls).
//
// Neither replaces a TPU kernel: on the TPU, XLA fused the stretch move
// (lumfuncmcmc_tpu/samplers/affine.py _half_step) into the program's step
// loop. Run eagerly, the same half-step is 15 small PyTorch ops (z: mul,
// add, pow, div; the partner gather; the proposal: sub, mul, add; the
// ratio: log, mul, add, sub; the compare; two wheres), each a launch and
// ~10-16 us of host dispatch, while the card works a few microseconds on
// 50 rows (PERF.md). What bounds these kernels is their launch: at W = 100
// a half-step moves ~50 x (4 D + 6) values, a few kilobytes, and does a
// few hundred float operations.
//
// Operands are (K, n[, D]) with the leading dimensions taken as one batch
// axis of K entries: u_z, j, ln_u, lnp and lnp_prop (K, n), x the moving
// half (K, n, D), other the fixed half (K, m, D). Within an entry the rows
// are dense; each operand comes with the stride between entries (the halves
// of an (E, W, D) state, and the ladder's per-rung randoms, are views with
// their own). Outputs are fresh, contiguous (K, n[, D]) tensors: the
// kernels write nothing they read.
//
// The arithmetic is the eager body's, in its order and in the operands'
// dtype T, each operation rounded once as PyTorch's own CUDA kernels round
// it (no contraction into an FMA: __fmul_rn, __fadd_rn, __fsub_rn, or the
// __d*_rn forms for double):
//   z     = ((c1 u + 1)^2) inv_a,  c1 = a - 1 and inv_a = 1 / a, each
//           taken on the host in double and rounded once to T: the scalar
//           multiply converts the host's a - 1; `** 2` is base * base; true
//           division by a host scalar multiplies by its reciprocal (PyTorch
//           2.11 on the card: 1 / 1.7 rounded from double, not 1 / 1.7f)
//   prop  = p + z (x - p),          p = other[j] of the same batch entry
//   ratio = ((c2 log z) + lnp') - lnp,  c2 = D - 1; log is logf or log
//   take  = ln_u < ratio;  new_pos, new_lnp = take ? (prop, lnp') : (x, lnp)
// so the chain, lnp and acceptances equal the eager path's bit for bit.
// stretch_accept recomputes z from u_z: nothing passes between the kernels
// but the proposal.

#include <cuda_runtime.h>

#define PROPOSE_THREADS 256
#define ACCEPT_THREADS 128

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float log_rn(float a) { return logf(a); }
__device__ __forceinline__ double log_rn(double a) { return log(a); }

template <typename T>
__device__ __forceinline__ T stretch_z(T u, T c1, T inv_a) {
    const T t = add_rn(mul_rn(u, c1), T(1));
    return mul_rn(mul_rn(t, t), inv_a);
}

// One thread an element (k, i, d) of the proposals.
template <typename T>
__global__ void __launch_bounds__(PROPOSE_THREADS)
stretch_propose(const T* __restrict__ u_z, const long long* __restrict__ j,
                const T* __restrict__ x, const T* __restrict__ other,
                T* __restrict__ prop, int n, int m, int d, long long total,
                long long s_u, long long s_j, long long s_x, long long s_o,
                T c1, T inv_a) {
    const long long e = (long long)blockIdx.x * PROPOSE_THREADS + threadIdx.x;
    if (e >= total) return;
    const int c = (int)(e % d);
    const long long row = e / d;
    const int i = (int)(row % n);
    const long long k = row / n;
    const T z = stretch_z(u_z[k * s_u + i], c1, inv_a);
    const long long jj = j[k * s_j + i];
    if (jj < 0 || jj >= m) __trap();      // as the eager gather's assert
    const T p = other[k * s_o + jj * d + c];
    prop[e] = add_rn(p, mul_rn(z, sub_rn(x[k * s_x + (long long)i * d + c],
                                         p)));
}

// One thread a row (k, i): the decision, the row's lnp and its D values.
template <typename T>
__global__ void __launch_bounds__(ACCEPT_THREADS)
stretch_accept(const T* __restrict__ u_z, const T* __restrict__ ln_u,
               const T* __restrict__ prop, const T* __restrict__ lnp_prop,
               const T* __restrict__ x, const T* __restrict__ lnp,
               T* __restrict__ new_pos, T* __restrict__ new_lnp,
               bool* __restrict__ accept, int n, int d, long long rows,
               long long s_u, long long s_l, long long s_p, long long s_x,
               long long s_lnp, T c1, T inv_a, T c2) {
    const long long r = (long long)blockIdx.x * ACCEPT_THREADS + threadIdx.x;
    if (r >= rows) return;
    const int i = (int)(r % n);
    const long long k = r / n;
    const T z = stretch_z(u_z[k * s_u + i], c1, inv_a);
    const T lp = lnp_prop[k * s_p + i], l0 = lnp[k * s_lnp + i];
    const T ratio = sub_rn(add_rn(mul_rn(log_rn(z), c2), lp), l0);
    const bool take = ln_u[k * s_l + i] < ratio;
    accept[r] = take;
    new_lnp[r] = take ? lp : l0;
    const T* src = take ? prop + r * d : x + k * s_x + (long long)i * d;
    T* dst = new_pos + r * d;
    for (int c = 0; c < d; ++c) dst[c] = src[c];
}

template <typename T>
static int propose(const void* u_z, const void* j, const void* x,
                   const void* other, void* prop, int k, int n, int m, int d,
                   long long s_u, long long s_j, long long s_x, long long s_o,
                   double c1, double inv_a, cudaStream_t st) {
    const long long total = (long long)k * n * d;
    const long long blocks = (total + PROPOSE_THREADS - 1) / PROPOSE_THREADS;
    stretch_propose<T><<<(unsigned)blocks, PROPOSE_THREADS, 0, st>>>(
        (const T*)u_z, (const long long*)j, (const T*)x, (const T*)other,
        (T*)prop, n, m, d, total, s_u, s_j, s_x, s_o, (T)c1, (T)inv_a);
    return (int)cudaGetLastError();
}

template <typename T>
static int accept_rows(const void* u_z, const void* ln_u, const void* prop,
                       const void* lnp_prop, const void* x, const void* lnp,
                       void* new_pos, void* new_lnp, bool* accept, int k,
                       int n, int d, long long s_u, long long s_l,
                       long long s_p, long long s_x, long long s_lnp,
                       double c1, double inv_a, double c2, cudaStream_t st) {
    const long long rows = (long long)k * n;
    const long long blocks = (rows + ACCEPT_THREADS - 1) / ACCEPT_THREADS;
    stretch_accept<T><<<(unsigned)blocks, ACCEPT_THREADS, 0, st>>>(
        (const T*)u_z, (const T*)ln_u, (const T*)prop, (const T*)lnp_prop,
        (const T*)x, (const T*)lnp, (T*)new_pos, (T*)new_lnp, accept, n, d,
        rows, s_u, s_l, s_p, s_x, s_lnp, (T)c1, (T)inv_a, (T)c2);
    return (int)cudaGetLastError();
}

extern "C" {

// u_z (K, n) and x (K, n, D), other (K, m, D) of float64 where f64 is set,
// else float32; j (K, n) int64 in [0, m); s_*: each operand's stride
// between batch entries, in elements; c1 = a - 1 and inv_a = 1 / a in
// double (the kernel rounds them to the dtype); prop: a fresh contiguous
// (K, n, D) tensor. Returns the cudaError_t of the launch (0 = success).
// One launch; allocates nothing.
int stretch_propose_launch(const void* u_z, const void* j, const void* x,
                           const void* other, void* prop, int k, int n,
                           int m, int d, long long s_u, long long s_j,
                           long long s_x, long long s_o, double c1,
                           double inv_a, int f64, void* stream) {
    if (k < 1 || n < 1 || m < 1 || d < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    return f64 ? propose<double>(u_z, j, x, other, prop, k, n, m, d, s_u,
                                 s_j, s_x, s_o, c1, inv_a, st)
               : propose<float>(u_z, j, x, other, prop, k, n, m, d, s_u, s_j,
                                s_x, s_o, c1, inv_a, st);
}

// u_z, ln_u, lnp_prop and lnp (K, n), x (K, n, D), of one dtype as
// stretch_propose_launch's; prop: its contiguous output; c2 = D - 1;
// new_pos (K, n, D), new_lnp (K, n) and accept (K, n) bool: fresh
// contiguous tensors. Returns the cudaError_t of the launch (0 = success).
// One launch; allocates nothing.
int stretch_accept_launch(const void* u_z, const void* ln_u,
                          const void* prop, const void* lnp_prop,
                          const void* x, const void* lnp, void* new_pos,
                          void* new_lnp, bool* accept, int k, int n, int d,
                          long long s_u, long long s_l, long long s_p,
                          long long s_x, long long s_lnp, double c1,
                          double inv_a, double c2, int f64, void* stream) {
    if (k < 1 || n < 1 || d < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    return f64 ? accept_rows<double>(u_z, ln_u, prop, lnp_prop, x, lnp,
                                     new_pos, new_lnp, accept, k, n, d, s_u,
                                     s_l, s_p, s_x, s_lnp, c1, inv_a, c2, st)
               : accept_rows<float>(u_z, ln_u, prop, lnp_prop, x, lnp,
                                    new_pos, new_lnp, accept, k, n, d, s_u,
                                    s_l, s_p, s_x, s_lnp, c1, inv_a, c2, st);
}

}  // extern "C"
