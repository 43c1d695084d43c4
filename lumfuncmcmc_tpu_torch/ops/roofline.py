"""The measured same-mix roofline (counterpart of
``lumfuncmcmc_tpu/ops/pallas_roofline.py``).

The likelihood kernels have no matrix structure: their ceiling is the
card's sustained rate on the transcendental mix they execute, not its
published float32 peak, which counts an ``expf`` or a log as one
operation where each is a sequence around a special-function unit (SFU)
instruction. :func:`roofline_chain` (the ``roofline_chain`` kernel of
``csrc/roofline.cu``, replacing ``_roofline_kernel``,
``pallas_roofline.py:59``) iterates the value kernel's own per-element
op chain in registers, and :func:`transcendental_peak` turns two such
runs into that rate. On the card the chain makes the calls of
``free_lnlike``'s ln fc (``csrc/lnlike.cu ln_fc_sfu``: ``rsqrtf``, the
SFU's ``__logf`` and ``__fdividef``, ``expf`` for the decay) plus the
integrand's ``expf``, several independent elements a thread
(:func:`kernel_layout`); the plain version computes the same function
with PyTorch's log and divide.

Counting convention (the JAX package's): a transcendental is one
exp/log/rsqrt on a useful element; the chain executes
``TRANSCENDENTALS_PER_ELEM`` = 4 per element per iteration (the divide is
not counted).

Dispatch rule: a CPU tensor takes the plain version (:func:`_chain`
iterated), a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import time

import torch

TRANSCENDENTALS_PER_ELEM = 4


def _chain(y):
    """One likelihood-shaped op chain, the JAX ``_chain`` op for op:
    2 exp + 1 log + 1 rsqrt + 1 div + ~10 mul/add, clamped back into
    (0.05, 0.95) so iterating it stays tame and data-dependent."""
    x = 3.0 * (y - 0.41)
    fc = torch.clamp(0.5 + 0.5 * x * torch.rsqrt(1.0 + x * x), min=1e-30)
    lf = torch.log(fc)
    d = 1.0 - 0.999 * torch.exp(-(y * 1.7 + 0.05))
    e = -0.3 + 0.25 * y - y * 0.125 + 0.11 * (lf / d)
    return torch.clamp(0.9 * torch.exp(e), 0.05, 0.95)


def roofline_chain_reference(x, iters: int):
    """Plain version of the kernel: ``iters`` applications of
    :func:`_chain` to every element of ``x``."""
    y = x
    for _ in range(int(iters)):
        y = _chain(y)
    return y


def _launch(x, iters):
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("roofline_chain takes a contiguous float32 tensor, "
                        f"got {x.dtype}")
    if not 0 < x.numel() < 2**31 or iters < 0:
        raise ValueError(f"roofline_chain: {x.numel()} elements, "
                         f"{iters} iterations")
    from lumfuncmcmc_tpu_torch.ops._build import load_library
    out = torch.empty_like(x)
    rc = load_library().roofline_chain_launch(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        x.numel(), int(iters),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"roofline_chain launch failed: CUDA error {rc}")
    return out


def kernel_layout(n: int) -> dict:
    """The kernel's launch for ``n`` elements on the current CUDA device:
    ``chains_per_thread`` (E), ``blocks``, ``threads`` a block,
    ``registers`` a thread, ``blocks_per_sm`` resident, ``sms`` and
    ``local_bytes`` (spills) a thread."""
    from lumfuncmcmc_tpu_torch.ops._build import load_library
    buf = (ctypes.c_int * 7)()
    rc = load_library().roofline_chain_layout(int(n), buf)
    if rc != 0:
        raise RuntimeError(f"roofline_chain layout query failed: CUDA "
                           f"error {rc}")
    return dict(zip(("chains_per_thread", "blocks", "threads", "registers",
                     "blocks_per_sm", "sms", "local_bytes"), buf))


def roofline_chain(x, iters: int):
    """``iters`` applications of :func:`_chain` to every element of ``x``:
    the plain version for a CPU tensor; for a CUDA tensor the
    ``roofline_chain`` kernel of ``csrc/`` (counted in ``.launches``) or
    an error."""
    if x.device.type == "cpu":
        return roofline_chain_reference(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"roofline_chain: unsupported device {x.device}")
    out = _launch(x, iters)
    roofline_chain.launches += 1
    return out


roofline_chain.launches = 0


def _timed_run(x, iters, reps):
    """Best-of-``reps`` time in seconds of one ``roofline_chain`` call:
    CUDA events on the card, the host clock on the CPU. Best-of, not the
    median: noise from neighbours only ever slows a call."""
    roofline_chain(x, iters)                  # build and warm up
    best = float("inf")
    for _ in range(max(1, int(reps))):
        if x.device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            roofline_chain(x, iters)
            b.record()
            b.synchronize()
            t = a.elapsed_time(b) * 1e-3
        else:
            t0 = time.perf_counter()
            roofline_chain(x, iters)
            t = time.perf_counter() - t0
        best = min(best, t)
    return best


def transcendental_peak(device="cuda", rows: int = 256, cols: int = 1024,
                        iters_lo: int = 512, iters_hi: int = 4608,
                        reps: int = 12):
    """The sustained rate of the likelihood's op chain on ``device`` (the
    card unless asked otherwise), from the slope between two iteration
    counts over a (rows, cols) float32 block, so the per-call overhead
    cancels. Returns the JAX function's keys: ``wall_lo_s``,
    ``wall_hi_s``, ``per_iter_s``, ``overhead_s``, ``elements_per_sec``,
    ``transcendentals_per_sec``, and the configuration."""
    device = torch.device(device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = (0.05 + 0.9 * torch.rand((rows, cols), generator=gen)).to(device)
    wall_lo = _timed_run(x, iters_lo, reps)
    wall_hi = _timed_run(x, iters_hi, reps)
    slope = max(wall_hi - wall_lo, 1e-12) / (int(iters_hi) - int(iters_lo))
    nelem = rows * cols
    return {
        "wall_lo_s": wall_lo,
        "wall_hi_s": wall_hi,
        "per_iter_s": slope,
        "overhead_s": max(wall_lo - slope * int(iters_lo), 0.0),
        "elements_per_sec": nelem / slope,
        "transcendentals_per_sec": TRANSCENDENTALS_PER_ELEM * nelem / slope,
        "rows": rows, "cols": cols,
        "iters_lo": int(iters_lo), "iters_hi": int(iters_hi),
        "reps": int(reps),
    }
