"""Hand-written CUDA kernels for the single-epoch log-likelihood
(counterpart of ``lumfuncmcmc_tpu/ops/pallas_lnlike.py``).

Per walker theta the kernels evaluate

    lnL = sum_n [ ln phi(L_n) + ln Omega(L_n, z_n | theta) ]
          - sum_{f,i,j} phi(logL[f,i,j]) * Omega(logf[f,i,j] | theta) * w[f,i,j]

in the factored form of the TPU kernels: the theta-independent
exponentials are precomputed on the host, ``P = 10^(logL - lref)`` and
``R = 10^(logf + 16)``, so the Schechter cutoff and the Fleming decay
ratio become multiplies by per-walker scalars. Theta enters as a
per-walker feature row (:func:`_features_free`, :func:`_features_fixed`).

Two kernels (``csrc/lnlike.cu``):

- :func:`free_lnlike` — free completeness; replaces both
  ``_kernel_free_bcast`` (``pallas_lnlike.py:601``) and ``_kernel_free``
  (``:761``);
- :func:`fixed_lnlike` — fixed completeness; replaces both
  ``_kernel_fixed_bcast`` (``:751``) and ``_kernel_fixed`` (``:813``).

The TPU's broadcast/slab split exists only because of VMEM and does not
carry over: one packing serves every catalog size. Cells and sources are
concatenated field by field (no lane padding) with ``(F+1,)`` field
offsets, and an int32 chunk table cuts each field's cells and sources
into pieces of at most ``CHUNK_CELLS`` for the (chunk, walker) launch
grid.

Dispatch rule: a CPU tensor takes the plain PyTorch version
(:func:`free_lnlike_reference`, :func:`fixed_lnlike_reference`), a CUDA
tensor launches the kernel or raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.cosmology import SQARCSEC_PER_SR
from lumfuncmcmc_tpu_torch.models.context import LFContext
from lumfuncmcmc_tpu_torch.models.likelihood import (
    ThetaLayout, _ln_term_collapsed, in_box)
from lumfuncmcmc_tpu_torch.ops.completeness import (
    _log10_inverse_fleming_ratio)
from lumfuncmcmc_tpu_torch.ops.schechter import LN10

_LOG_LN10 = math.log(LN10)
_LOGF_REF = -16.0       # reference log10-flux for the R factorization
CHUNK_CELLS = 2048      # cells (or sources) one CUDA block reduces


def _clamp_flim(theta, layout: ThetaLayout):
    """Keep theta's Flim block positive for the ``log10`` in the feature
    map; out-of-box thetas are masked by the caller."""
    if layout.fix_comp:
        return theta
    nf = layout.nfields
    k = 2 if layout.fix_sch_al else 3
    flim = torch.clamp(theta[:, k:k + nf], min=1e-6)
    return torch.cat([theta[:, :k], flim, theta[:, k + nf:]], dim=1)


# ---------------------------------------------------------------------------
# data preparation (host side, once per context)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CudaGridData:
    """Per-field concatenated cell and source arrays for the kernels.

    Grid arrays are (C,), source arrays (N,), fields back to back;
    ``grid_off``/``src_off`` hold the (F+1,) field offsets on the host
    (for the plain versions). ``chunks`` is the (nchunks, 4) int32
    launch table ``(field, start, end, is_source)`` on the device, from
    which each kernel block reads its field and cell range. Fixed completeness keeps only
    ``g_a``, ``g_p`` and ``g_w``.
    """

    g_a: torch.Tensor                  # LN10 * logL
    g_p: torch.Tensor                  # 10^(logL - lref)
    g_w: torch.Tensor                  # quadrature weight * area * ln10
    g_logf: Optional[torch.Tensor]     # log10 flux of grid cells
    g_r: Optional[torch.Tensor]        # 10^(logf - logf_ref)
    s_logf: Optional[torch.Tensor]
    s_a: Optional[torch.Tensor]
    s_p: Optional[torch.Tensor]
    s_r: Optional[torch.Tensor]
    s_lnom0: Optional[torch.Tensor]    # ln(Omega0_src / sqarcsec)
    s_mask: Optional[torch.Tensor]
    chunks: torch.Tensor
    grid_off: tuple
    src_off: tuple
    lref: float
    nfields: int
    fcmin: float                       # 0 disables the faint-end term


def _grid_cols(ctx: LFContext, fix_comp: bool, lref: float):
    """Per-field grid feature dicts (float64 numpy). Free completeness
    folds the per-field area fraction and the ln10 Schechter prefactor
    into the weights; fixed completeness uses the frozen ``w_fixed``
    (area and Omega already inside) times ln10."""
    logL = ctx.logL_grid.double().cpu().numpy()
    nf = logL.shape[0]
    if fix_comp:
        w = ctx.w_fixed.double().cpu().numpy() * LN10
        logf = np.zeros_like(logL) + _LOGF_REF
    else:
        om0_f = ctx.omega0_f.double().cpu().numpy() / SQARCSEC_PER_SR
        w = ctx.w_open.double().cpu().numpy() * om0_f[:, None, None] * LN10
        logf = ctx.logf_grid.double().cpu().numpy()
    gcols = []
    for f in range(nf):
        ll, lf = logL[f].ravel(), logf[f].ravel()
        gcols.append({
            "logf": lf, "a": LN10 * ll,
            "p": 10.0 ** np.clip(ll - lref, -30.0, 25.0),
            "r": 10.0 ** np.clip(lf - _LOGF_REF, -30.0, 25.0),
            "w": w[f].ravel(),
        })
    return gcols


def _concat(per_field, names):
    """Concatenate per-field column dicts -> (arrays by name, offsets)."""
    counts = [len(cols[names[0]]) for cols in per_field]
    off = tuple(int(x) for x in np.concatenate([[0], np.cumsum(counts)]))
    return {nm: np.concatenate([cols[nm] for cols in per_field])
            for nm in names}, off


def _chunk_table(grid_off, src_off):
    """(field, start, end, is_source) rows cutting every field's cells
    and sources into pieces of at most CHUNK_CELLS."""
    rows = []
    for is_src, off in ((0, grid_off), (1, src_off)):
        for f in range(len(off) - 1):
            for s in range(off[f], off[f + 1], CHUNK_CELLS):
                rows.append((f, s, min(s + CHUNK_CELLS, off[f + 1]),
                             is_src))
    return np.asarray(rows, dtype=np.int32).reshape(-1, 4)


def prepare_cuda_data(ctx: LFContext, fix_comp: bool, fcmin: float = 0.0,
                      dtype=None) -> CudaGridData:
    """Pack the context grids and sources into the kernel layout, on the
    context's device, in ``dtype`` (default: the context's)."""
    device = ctx.lum.device
    dtype = dtype or ctx.lum.dtype
    lref = float(ctx.lref)
    nf = int(ctx.logL_grid.shape[0])
    gcols = _grid_cols(ctx, fix_comp, lref)
    g, grid_off = _concat(gcols, ["logf", "a", "p", "r", "w"])

    src_off = (0,) * (nf + 1)
    s = {}
    if not fix_comp:
        # sources sorted by field (stable, in-field order kept)
        fid = ctx.field_id.cpu().numpy()
        lum = ctx.lum.double().cpu().numpy()
        logf_s = ctx.logf_src.double().cpu().numpy()
        om0_s = ctx.omega0_src.double().cpu().numpy() / SQARCSEC_PER_SR
        mask = ctx.src_mask.double().cpu().numpy()
        scols = []
        for f in range(nf):
            sel = np.nonzero(fid == f)[0]
            scols.append({
                "logf": logf_s[sel], "a": LN10 * lum[sel],
                "p": 10.0 ** np.clip(lum[sel] - lref, -30.0, 25.0),
                "r": 10.0 ** np.clip(logf_s[sel] - _LOGF_REF, -30.0, 25.0),
                "lnom0": np.log(np.maximum(om0_s[sel], 1e-300)),
                "mask": mask[sel],
            })
        s, src_off = _concat(scols, ["logf", "a", "p", "r", "lnom0",
                                     "mask"])

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def opt(a, nm):
        return None if fix_comp else t(a[nm])

    return CudaGridData(
        g_a=t(g["a"]), g_p=t(g["p"]), g_w=t(g["w"]),
        g_logf=opt(g, "logf"), g_r=opt(g, "r"),
        s_logf=opt(s, "logf"), s_a=opt(s, "a"), s_p=opt(s, "p"),
        s_r=opt(s, "r"), s_lnom0=opt(s, "lnom0"), s_mask=opt(s, "mask"),
        chunks=torch.as_tensor(_chunk_table(grid_off, src_off),
                               device=device),
        grid_off=grid_off, src_off=src_off, lref=lref, nfields=nf,
        fcmin=float(fcmin) if fcmin else 0.0)


# ---------------------------------------------------------------------------
# feature maps (theta -> per-walker kernel scalars)
# ---------------------------------------------------------------------------

def _feat_free_one(theta, layout: ThetaLayout, lref: float, fcmin: float):
    """(W, D) thetas -> (W, 6+2F) free-completeness features::

        0 c_grid = LN10*phistar            3 lA = LN10*Lstar
        1 c_src  = ln(ln10) + LN10*phistar 4 t1 = 10^(lref - Lstar)
        2 aA = sch_al + 1                  5 alpha_c
        6+f    logF50_f
        6+F+f  t2_f = 10^(logf_ref - log_ftau_f)   (1 when fcmin = 0:
                                                    the kernels skip it)
    """
    lstar, phistar, sch_al, logf50, alpha_c = layout.unpack(theta)
    if fcmin:
        log_ftau = logf50 + _log10_inverse_fleming_ratio(
            alpha_c, fcmin)[:, None]
        t2 = 10.0 ** (_LOGF_REF - log_ftau)
    else:
        t2 = torch.ones_like(logf50)
    return torch.cat([
        torch.stack([LN10 * phistar,
                     _LOG_LN10 + LN10 * phistar,
                     sch_al + 1.0,
                     LN10 * lstar,
                     10.0 ** (lref - lstar),
                     alpha_c], dim=1),
        logf50,
        t2,
    ], dim=1)


def _features_free(thetas, layout, lref, fcmin, dtype):
    """(W, D) thetas -> contiguous (W, 6+2F) features in ``dtype``."""
    return _feat_free_one(thetas, layout, lref, fcmin).to(dtype).contiguous()


def _feat_fixed_one(theta, ctx: LFContext, layout: ThetaLayout,
                    lref: float):
    """(W, D) thetas -> (W, 5) fixed-completeness features
    ``[c_grid, aA, lA, t1, lnpart]``; the O(1) collapsed ln-term rides
    along as ``lnpart`` so the kernel emits the complete lnlike."""
    lstar, phistar, sch_al, _, _ = layout.unpack(theta)
    lnpart = _ln_term_collapsed(ctx, lstar, phistar, sch_al)
    return torch.stack([LN10 * phistar, sch_al + 1.0, LN10 * lstar,
                        10.0 ** (lref - lstar), lnpart], dim=1)


def _features_fixed(thetas, ctx, layout, lref, dtype):
    """(W, D) thetas -> contiguous (W, 5) features in ``dtype``."""
    return _feat_fixed_one(thetas, ctx, layout, lref).to(dtype).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the on-card reference)
# ---------------------------------------------------------------------------

def _ln_fc(logf, r, ac, lf50, t2, fcmin):
    """ln Fleming completeness for (W, n) cells; fc is clamped at 1e-30
    as in the TPU kernels, so an underflow cannot turn an in-bounds
    lnlike into -inf on one engine only."""
    x = ac * (logf - lf50)
    fc = torch.clamp(0.5 + 0.5 * x * torch.rsqrt(1.0 + x * x), min=1e-30)
    lf = torch.log(fc)
    if not fcmin:
        return lf
    return lf / (1.0 - torch.exp(-(r * t2)))


def free_lnlike_reference(feats, data: CudaGridData):
    """Plain version of the free-completeness kernel: the same factored
    math per field, in the dtype of ``feats``. (W, 6+2F) -> (W,)."""
    nf, fcmin = data.nfields, data.fcmin
    c_g, c_s, aA, lA, t1, ac = (feats[:, i:i + 1] for i in range(6))
    tot = torch.zeros(feats.shape[0], dtype=feats.dtype,
                      device=feats.device)
    for f in range(nf):
        lf50 = feats[:, 6 + f:7 + f]
        t2 = feats[:, 6 + nf + f:7 + nf + f]
        g = slice(data.grid_off[f], data.grid_off[f + 1])
        e = (c_g + aA * (data.g_a[g] - lA) - data.g_p[g] * t1
             + _ln_fc(data.g_logf[g], data.g_r[g], ac, lf50, t2, fcmin))
        tot = tot - (torch.exp(e) * data.g_w[g]).sum(dim=1)
        s = slice(data.src_off[f], data.src_off[f + 1])
        contrib = (c_s + aA * (data.s_a[s] - lA) - data.s_p[s] * t1
                   + data.s_lnom0[s]
                   + _ln_fc(data.s_logf[s], data.s_r[s], ac, lf50, t2,
                            fcmin))
        tot = tot + torch.where(data.s_mask[s] > 0.0, contrib,
                                torch.zeros_like(contrib)).sum(dim=1)
    return tot


def fixed_lnlike_reference(feats, data: CudaGridData):
    """Plain version of the fixed-completeness kernel. (W, 5) -> (W,)."""
    c, aA, lA, t1, lnpart = (feats[:, i:i + 1] for i in range(5))
    e = c + aA * (data.g_a - lA) - data.g_p * t1
    return lnpart[:, 0] - (torch.exp(e) * data.g_w).sum(dim=1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check_cuda_inputs(feats, nfeat, data, arrays):
    if feats.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take float32 features, got "
                        f"{feats.dtype}")
    if feats.dim() != 2 or feats.shape[1] != nfeat:
        raise ValueError(f"features must be (W, {nfeat}), got "
                         f"{tuple(feats.shape)}")
    if not 0 < feats.shape[0] <= 65535:
        raise ValueError(f"walker batch of {feats.shape[0]} is outside "
                         "the kernel's 1..65535 launch range")
    if not feats.is_contiguous():
        raise ValueError("features must be contiguous")
    for a in arrays + (data.chunks,):
        if a.device != feats.device:
            raise ValueError(f"grid data on {a.device}, features on "
                             f"{feats.device}")
        if not a.is_contiguous():
            raise ValueError("grid data must be contiguous")
    for a in arrays:
        if a.dtype != torch.float32:
            raise TypeError(f"grid data must be float32, got {a.dtype}")


def _launch_checked(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def free_lnlike(feats, data: CudaGridData):
    """Free-completeness lnlike, (W, 6+2F) features -> (W,).

    CPU tensors take :func:`free_lnlike_reference`; CUDA tensors launch
    the ``free_lnlike`` kernel of ``csrc/lnlike.cu`` or raise.
    """
    if feats.device.type == "cpu":
        return free_lnlike_reference(feats, data)
    if feats.device.type != "cuda":
        raise ValueError(f"free_lnlike: unsupported device {feats.device}")
    from lumfuncmcmc_tpu_torch.ops._build import load_library
    arrays = (data.g_logf, data.g_a, data.g_p, data.g_r, data.g_w,
              data.s_logf, data.s_a, data.s_p, data.s_r, data.s_lnom0,
              data.s_mask)
    _check_cuda_inputs(feats, 6 + 2 * data.nfields, data, arrays)
    lib = load_library()
    w, nchunks = feats.shape[0], data.chunks.shape[0]
    partial = torch.empty((w, nchunks), dtype=torch.float32,
                          device=feats.device)
    out = torch.empty(w, dtype=torch.float32, device=feats.device)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    rc = lib.free_lnlike_launch(
        _ptr(feats), w, feats.shape[1], data.nfields,
        *(_ptr(a) for a in arrays), _ptr(data.chunks), nchunks,
        int(bool(data.fcmin)), _ptr(partial), _ptr(out),
        ctypes.c_void_p(stream))
    _launch_checked("free_lnlike", rc)
    free_lnlike.launches += 1
    return out


free_lnlike.launches = 0


def fixed_lnlike(feats, data: CudaGridData):
    """Fixed-completeness lnlike, (W, 5) features -> (W,).

    CPU tensors take :func:`fixed_lnlike_reference`; CUDA tensors launch
    the ``fixed_lnlike`` kernel of ``csrc/lnlike.cu`` or raise.
    """
    if feats.device.type == "cpu":
        return fixed_lnlike_reference(feats, data)
    if feats.device.type != "cuda":
        raise ValueError(f"fixed_lnlike: unsupported device {feats.device}")
    from lumfuncmcmc_tpu_torch.ops._build import load_library
    arrays = (data.g_a, data.g_p, data.g_w)
    _check_cuda_inputs(feats, 5, data, arrays)
    lib = load_library()
    w, nchunks = feats.shape[0], data.chunks.shape[0]
    partial = torch.empty((w, nchunks), dtype=torch.float32,
                          device=feats.device)
    out = torch.empty(w, dtype=torch.float32, device=feats.device)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    rc = lib.fixed_lnlike_launch(
        _ptr(feats), w, feats.shape[1], *(_ptr(a) for a in arrays),
        _ptr(data.chunks), nchunks, _ptr(partial), _ptr(out),
        ctypes.c_void_p(stream))
    _launch_checked("fixed_lnlike", rc)
    fixed_lnlike.launches += 1
    return out


fixed_lnlike.launches = 0


# ---------------------------------------------------------------------------
# public builder
# ---------------------------------------------------------------------------

def make_cuda_lnprob(ctx: LFContext, layout: ThetaLayout):
    """(W, D) -> (W,) lnprob through the hand-written kernels, with the
    semantics of ``make_lnprob``: the box-prior mask is applied outside
    the kernel, so an out-of-box theta gives -inf.

    On a CUDA context the kernels run in float32 whatever the context's
    dtype (as the TPU kernels do); on the CPU the plain versions run in
    the context's dtype. The result comes back in the thetas' dtype.
    On a CUDA context the kernel library is built and loaded here, so
    the first lnprob call (inside the sampler's timed window) does not
    pay for it.
    """
    device = ctx.lum.device
    if device.type == "cuda":
        from lumfuncmcmc_tpu_torch.ops._build import load_library
        load_library()
    kdtype = torch.float32 if device.type == "cuda" else ctx.lum.dtype
    data = prepare_cuda_data(ctx, layout.fix_comp, layout.fcmin,
                             dtype=kdtype)
    # bounds made once: a host tensor per call would sync the device
    lo, hi = layout.bounds_arrays(ctx.lum.dtype, device)

    def batched(thetas):
        th = _clamp_flim(thetas, layout)
        if layout.fix_comp:
            lnl = fixed_lnlike(
                _features_fixed(th, ctx, layout, data.lref, kdtype), data)
        else:
            lnl = free_lnlike(
                _features_free(th, layout, data.lref, data.fcmin, kdtype),
                data)
        lnl = lnl.to(thetas.dtype)
        return torch.where(in_box(thetas, lo, hi), lnl,
                           torch.full_like(lnl, -math.inf))

    batched.engine = "cuda" if device.type == "cuda" else "plain"
    return batched
