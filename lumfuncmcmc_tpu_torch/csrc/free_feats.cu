// The feature map of the free-completeness value path on Hopper (sm_90a):
// (W, D) thetas -> the (W, 6+2F) float32 feature rows that free_lnlike
// (lnlike.cu) reads, and each row's prior-box flag, in one launch.
//
// It replaces no TPU kernel: on the TPU, XLA fused the feature map
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

template <typename T>
__global__ void __launch_bounds__(FEATS_THREADS)
free_feats(const T* __restrict__ thetas, int nwalkers, FreeFeatsParams p,
           float* __restrict__ feats, bool* __restrict__ inside) {
    const int w = blockIdx.x * FEATS_THREADS + threadIdx.x;
    if (w >= nwalkers) return;
    const T* th = thetas + (size_t)w * p.ndim;
    const int nf = p.nfields, k = p.fix_sch_al ? 2 : 3;
    float* out = feats + (size_t)w * (6 + 2 * nf);

    bool ok = true;
    for (int j = 0; j < p.ndim; ++j) {
        const double v = (double)th[j];
        ok &= (v >= p.box[j]) & (v <= p.box[p.ndim + j]);
    }
    inside[w] = ok;

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
        out[6 + f] = __double2float_rn(lf50);
        out[6 + nf + f] = p.fcmin
            ? __double2float_rn(
                  pow(10.0, __dsub_rn(LOGF_REF, __dadd_rn(lf50, ratio))))
            : 1.0f;
    }
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

}  // extern "C"
