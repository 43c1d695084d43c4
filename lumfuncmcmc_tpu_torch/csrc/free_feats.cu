// The feature maps of the free-completeness value paths on Hopper (sm_90a):
// (W, D) thetas -> the (W, 6+2F) float32 feature rows that free_lnlike
// (lnlike.cu) reads, and each row's prior-box flag, in one launch
// (free_feats); for the streaming route also the float64 collapsed source
// terms (stream_feats, below).
//
// Neither replaces a TPU kernel: on the TPU, XLA fused the feature map
// (lumfuncmcmc_tpu/ops/pallas_lnlike.py's feature rows of _kernel_free_bcast)
// into one op around the Pallas call. Run eagerly, the same map is ~30
// small float64 PyTorch ops a call on 50 rows (ops/cuda_lnlike.py
// _clamp_flim, _feat_free_one, _round_st, and the prior test in_box), each a
// launch and ~15 us of host dispatch, while the device works ~24 us of the
// ~630 us call (PERF.md). What bounds this kernel is its launch: a thread a
// walker row, ~D loads, 6+2F float32 stores, F log10 and F+1 pow in
// float64, a few microseconds at any W the samplers use.
//
// Per row, in float64, the operations of the PyTorch map in its order, each
// rounded once as PyTorch's own kernel rounds it (no contraction into an
// FMA: __dmul_rn, __dadd_rn, __dsub_rn), so the rows equal the map's:
//   Flim_f   = max(theta Flim_f, 1e-6)  (NaN kept, as torch.clamp keeps it)
//   logF50_f = log10(Flim_f) - 17
//   ratio    = sign * sqrt((1 / alpha_c^2) * A),  A = |a / (1 - a)|,
//              a = (2 fcmin - 1)^2, sign that of 2 fcmin - 1 (completeness.py
//              _fleming_ratio_constants, taken on the host)
//   t2_f     = 10^(-16 - (logF50_f + ratio)), or 1 where fcmin is 0
//   [LN10 phistar, LN10 phistar + ln(ln10), sch_al + 1, LN10 (Lstar - lref),
//    10^(lref - Lstar), alpha_c, logF50_f.., t2_f..]
// then each feature rounded to float32 once (__double2float_rn), as
// _round_st and the cast before the value kernel round it. sch_al is
// theta's, or sch_al0 where it is fixed. The flag is all(lo <= theta <= hi)
// over the row, compared in float64 (exact for float32 thetas and bounds,
// and what PyTorch's promotion compares for mixed ones); NaN is outside.
// Every row gets its features, inside the box or not.
//
// The streaming value path's kernel (stream_feats; ops/cuda_lnlike.py
// _features_stream, in_box and _stream_collapsed) runs the same map a row,
// with columns 6..6+F taken as logF50_f - LOGF_REF in float64 before the
// one rounding (the streaming kernels' flux reference), and adds the float64
// theta-affine source terms of shard 0 from its catalog sums
// (n, sum(lum - lref), sum P, sum ln Omega0), in _collapsed's order:
//   n (ln(ln10) + c) + aA (LN10 sum_rel - n lA) - t1 sum_P + sum_lnOmega
// where c, aA, lA, t1 are the row's own float32 columns 0, 2, 3, 4 promoted
// to float64, so that the grid part (the value kernel reads those floats)
// and the source part read one rounding of LN10 phistar: two roundings
// ~1e-6 apart would move lnL by ~N 1e-6. Each operation rounded once, as
// PyTorch's eager ops round them, so the column equals _stream_collapsed
// of the kernel's rows bit for bit.

#include <cuda_runtime.h>

#define FEATS_THREADS 128
#define LN10 2.302585092994046            // ops/schechter.py LN10
#define LOG_LN10 0.834032445247956        // ln(LN10), cuda_lnlike._LOG_LN10
#define LOGF_REF (-16.0)                  // cuda_lnlike._LOGF_REF

// What the host looks up once per route (ops/cuda_lnlike.py
// _FreeFeatsParams, the same fields in the same order).
struct FreeFeatsParams {
    const double* box;    // (2, D) float64: the prior box's lo row, hi row
    double sch_al0;       // sch_al where fix_sch_al is set
    double lref;
    double ratio_a;       // A = |a / (1 - a)|
    double ratio_sign;    // the sign of 2 fcmin - 1
    int ndim;             // D
    int nfields;          // F
    int fix_sch_al;
    int fcmin;            // 0: t2 is 1
};

__device__ __forceinline__ double clamp_flim(double v) {
    return v < 1e-6 ? 1e-6 : v;           // NaN fails the test and stays
}

// What the host looks up once for the streaming route (ops/cuda_lnlike.py
// _StreamFeatsParams, the same fields in the same order): FreeFeatsParams'
// and the shard's catalog sums.
struct StreamFeatsParams {
    const double* box;    // (2, D) float64: the prior box's lo row, hi row
    const double* sums;   // (4,) float64: n, sum(lum - lref), sum P,
                          // sum ln Omega0
    double sch_al0;
    double lref;
    double ratio_a;
    double ratio_sign;
    int ndim;
    int nfields;
    int fix_sch_al;
    int fcmin;
};

// One walker row th of the map into out (6+2F floats); returns its prior
// flag. Stream: columns 6..6+F hold logF50_f - LOGF_REF.
template <bool Stream, typename T, typename P>
__device__ __forceinline__ bool feat_row(const T* th, const P& p,
                                         float* out) {
    const int nf = p.nfields, k = p.fix_sch_al ? 2 : 3;

    bool ok = true;
    for (int j = 0; j < p.ndim; ++j) {
        const double v = (double)th[j];
        ok &= (v >= p.box[j]) & (v <= p.box[p.ndim + j]);
    }

    const double lstar = (double)th[0];
    const double c_grid = __dmul_rn((double)th[1], LN10);
    const double sch_al = p.fix_sch_al ? p.sch_al0 : (double)th[2];
    const double alpha_c = (double)th[k + nf];
    out[0] = __double2float_rn(c_grid);
    out[1] = __double2float_rn(__dadd_rn(c_grid, LOG_LN10));
    out[2] = __double2float_rn(__dadd_rn(sch_al, 1.0));
    out[3] = __double2float_rn(__dmul_rn(__dsub_rn(lstar, p.lref), LN10));
    out[4] = __double2float_rn(pow(10.0, __dsub_rn(p.lref, lstar)));
    out[5] = __double2float_rn(alpha_c);

    double ratio = 0.0;
    if (p.fcmin)
        ratio = __dmul_rn(sqrt(__dmul_rn(
                    __ddiv_rn(1.0, __dmul_rn(alpha_c, alpha_c)), p.ratio_a)),
                          p.ratio_sign);
    for (int f = 0; f < nf; ++f) {
        const double lf50 = __dsub_rn(log10(clamp_flim((double)th[k + f])),
                                      17.0);
        out[6 + f] = __double2float_rn(Stream ? __dsub_rn(lf50, LOGF_REF)
                                              : lf50);
        out[6 + nf + f] = p.fcmin
            ? __double2float_rn(
                  pow(10.0, __dsub_rn(LOGF_REF, __dadd_rn(lf50, ratio))))
            : 1.0f;
    }
    return ok;
}

template <typename T>
__global__ void __launch_bounds__(FEATS_THREADS)
free_feats(const T* __restrict__ thetas, int nwalkers, FreeFeatsParams p,
           float* __restrict__ feats, bool* __restrict__ inside) {
    const int w = blockIdx.x * FEATS_THREADS + threadIdx.x;
    if (w >= nwalkers) return;
    inside[w] = feat_row<false>(thetas + (size_t)w * p.ndim, p,
                                feats + (size_t)w * (6 + 2 * p.nfields));
}

template <typename T>
__global__ void __launch_bounds__(FEATS_THREADS)
stream_feats(const T* __restrict__ thetas, int nwalkers, StreamFeatsParams p,
             float* __restrict__ feats, bool* __restrict__ inside,
             double* __restrict__ coll) {
    const int w = blockIdx.x * FEATS_THREADS + threadIdx.x;
    if (w >= nwalkers) return;
    float* out = feats + (size_t)w * (6 + 2 * p.nfields);
    inside[w] = feat_row<true>(thetas + (size_t)w * p.ndim, p, out);
    // _collapsed from the floats just stored, in its order
    const double c = out[0], aA = out[2], lA = out[3], t1 = out[4];
    const double n = p.sums[0];
    double v = __dmul_rn(n, __dadd_rn(c, LOG_LN10));
    v = __dadd_rn(v, __dmul_rn(aA, __dsub_rn(__dmul_rn(LN10, p.sums[1]),
                                             __dmul_rn(n, lA))));
    v = __dsub_rn(v, __dmul_rn(t1, p.sums[2]));
    coll[w] = __dadd_rn(v, p.sums[3]);
}

extern "C" {

// thetas: (W, D) contiguous device rows, float64 where theta_f64 is set,
// else float32; params: a host pointer to the route's FreeFeatsParams;
// feats (W, 6+2F) float32 and inside (W,) bool on the device. Returns the
// cudaError_t of the launch (0 = success). One launch; allocates nothing.
int free_feats_launch(const void* thetas, int nwalkers, int theta_f64,
                      const FreeFeatsParams* params, float* feats,
                      bool* inside, void* stream) {
    const FreeFeatsParams p = *params;
    if (nwalkers < 1 || p.nfields < 1
            || p.ndim != (p.fix_sch_al ? 2 : 3) + p.nfields + 1)
        return (int)cudaErrorInvalidValue;
    const int blocks = (nwalkers + FEATS_THREADS - 1) / FEATS_THREADS;
    cudaStream_t st = (cudaStream_t)stream;
    if (theta_f64)
        free_feats<double><<<blocks, FEATS_THREADS, 0, st>>>(
            (const double*)thetas, nwalkers, p, feats, inside);
    else
        free_feats<float><<<blocks, FEATS_THREADS, 0, st>>>(
            (const float*)thetas, nwalkers, p, feats, inside);
    return (int)cudaGetLastError();
}

// thetas as free_feats_launch's; params: a host pointer to the route's
// StreamFeatsParams; feats (W, 6+2F) float32, inside (W,) bool and coll
// (W,) float64 (the collapsed source terms) on the device. Returns the
// cudaError_t of the launch (0 = success). One launch; allocates nothing.
int stream_feats_launch(const void* thetas, int nwalkers, int theta_f64,
                        const StreamFeatsParams* params, float* feats,
                        bool* inside, double* coll, void* stream) {
    const StreamFeatsParams p = *params;
    if (nwalkers < 1 || p.nfields < 1 || p.sums == nullptr
            || p.ndim != (p.fix_sch_al ? 2 : 3) + p.nfields + 1)
        return (int)cudaErrorInvalidValue;
    const int blocks = (nwalkers + FEATS_THREADS - 1) / FEATS_THREADS;
    cudaStream_t st = (cudaStream_t)stream;
    if (theta_f64)
        stream_feats<double><<<blocks, FEATS_THREADS, 0, st>>>(
            (const double*)thetas, nwalkers, p, feats, inside, coll);
    else
        stream_feats<float><<<blocks, FEATS_THREADS, 0, st>>>(
            (const float*)thetas, nwalkers, p, feats, inside, coll);
    return (int)cudaGetLastError();
}

}  // extern "C"
