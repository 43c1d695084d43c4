"""The stretch move's half-step as two kernels (``csrc/stretch.cu``).

:func:`stretch_propose` forms the proposals of the moving half-ensemble,
``partner + z (x - partner)`` with ``z = ((a - 1) u + 1)^2 / a``, and
:func:`stretch_accept` takes or keeps each walker after the lnprob call:
``ln_u < (D - 1) ln z + lnp' - lnp``. The sampler's ``_half_step``
(``samplers/affine.py``) calls the one, its lnprob, then the other. Run
eagerly on the card the same arithmetic is 15 small PyTorch ops a
half-step, each a launch; neither kernel replaces a TPU kernel (XLA fused
the stretch move into the program's step loop).

Operands are the half-step's: the randoms ``u_z``, ``j``, ``ln_u`` and
the walkers' ``lnp`` (..., n), the moving half ``x`` (..., n, D), the
fixed half (..., m, D); leading dimensions are independent ensembles (the
tempered ladder's rungs, replicated ensembles), each drawing partners
from its own fixed half. Every output is a fresh tensor: the lnprob call
may keep the proposals by reference.

Dispatch rule (``ops/_wrapper.py``, as for the kernels of
``ops/cuda_lnlike.py``): a CPU tensor takes the plain version, the eager
ops with their bits; a CUDA tensor launches the kernel, whose arithmetic
is those ops' in their order and rounding, or raises. The kernels take
float32 or float64 walkers, every float operand and the lnprob's return
of their dtype, ``j`` int64, and every operand of the walkers' shape on
their card; a batch of several leading axes, or rows that are not dense,
go as a view or copy that is one batch axis of dense rows.
"""

from __future__ import annotations

import torch

from lumfuncmcmc_tpu_torch.ops._wrapper import wrapper

_FLOATS = (torch.float32, torch.float64)


def _z(u_z, a):
    return ((a - 1.0) * u_z + 1.0) ** 2 / a


def stretch_propose_reference(move_pos, other_pos, u_z, j, a):
    """Plain version of :func:`stretch_propose`: the eager ops."""
    z = _z(u_z, a)
    partner = torch.take_along_dim(other_pos, j[..., None], dim=-2)
    return partner + z[..., None] * (move_pos - partner)


def stretch_accept_reference(prop, lnp_prop, move_pos, move_lnp, u_z, ln_u,
                             a, ndim):
    """Plain version of :func:`stretch_accept`: the eager ops."""
    ln_ratio = (ndim - 1.0) * torch.log(_z(u_z, a)) + lnp_prop - move_lnp
    accept = ln_u < ln_ratio
    new_pos = torch.where(accept[..., None], prop, move_pos)
    new_lnp = torch.where(accept, lnp_prop, move_lnp)
    return new_pos, new_lnp, accept


def _batched(t, what, shape, dtype, dev, dims):
    """``t``, which must be of ``shape``, ``dtype`` and on card ``dev``,
    as a batch of entries whose last ``dims`` dimensions are dense, and
    the stride between its entries: itself where it is one such batch
    axis or none, else :func:`_dense`'s view or copy."""
    if t.shape != shape or t.dtype is not dtype or t.get_device() != dev:
        raise TypeError(
            f"stretch kernels: {what} is {t.dtype} {tuple(t.shape)} on "
            f"{t.device}; the walkers' operands take {dtype} "
            f"{tuple(shape)} on cuda:{dev}")
    st = t.stride()
    if st[-1] == 1 and (dims == 1 or st[-2] == shape[-1]):
        if len(st) == dims + 1:
            return t, st[0]
        if len(st) == dims:
            return t, 0
    return _dense(t, dims)


def _dense(t, dims):
    """``t`` with its leading dimensions taken as one and its last
    ``dims`` dense (a view where it can be, else a copy), and the stride
    between its entries."""
    if t.dim() > dims + 1:
        t = t.flatten(0, -dims - 1)
    if t.stride(-1) != 1 or (dims == 2 and t.stride(-2) != t.shape[-1]):
        t = t.contiguous()
    return t, (t.stride(0) if t.dim() > dims else 0)


def _walkers(move_pos):
    """(K, n, D, dtype, card) of the moving half (..., n, D)."""
    dt, dev = move_pos.dtype, move_pos.get_device()
    if dt not in _FLOATS or dev < 0:
        raise TypeError(f"stretch kernels: walkers of {dt} on "
                        f"{move_pos.device}; the kernels take float32 or "
                        "float64 on a CUDA device")
    n, d = move_pos.shape[-2:]
    return move_pos.numel() // max(n * d, 1), n, d, dt, dev


def _launch_propose(name, move_pos, other_pos, u_z, j, a):
    from lumfuncmcmc_tpu_torch.ops._build import load_library
    k, n, d, dt, dev = _walkers(move_pos)
    rows = move_pos.shape[:-1]
    m = other_pos.shape[-2]
    u_z, s_u = _batched(u_z, "u_z", rows, dt, dev, 1)
    j, s_j = _batched(j, "j", rows, torch.int64, dev, 1)
    x, s_x = _batched(move_pos, "move_pos", move_pos.shape, dt, dev, 2)
    other, s_o = _batched(other_pos, "other_pos", rows[:-1] + (m, d), dt,
                          dev, 2)
    prop = move_pos.new_empty(move_pos.shape)
    rc = getattr(load_library(), f"{name}_launch")(
        u_z.data_ptr(), j.data_ptr(), x.data_ptr(), other.data_ptr(),
        prop.data_ptr(), k, n, m, d, s_u, s_j, s_x, s_o, a - 1.0, 1.0 / a,
        dt is torch.float64, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return prop


def _launch_accept(name, prop, lnp_prop, move_pos, move_lnp, u_z, ln_u, a,
                   ndim):
    from lumfuncmcmc_tpu_torch.ops._build import load_library
    k, n, d, dt, dev = _walkers(move_pos)
    rows = move_pos.shape[:-1]
    u_z, s_u = _batched(u_z, "u_z", rows, dt, dev, 1)
    ln_u, s_l = _batched(ln_u, "ln_u", rows, dt, dev, 1)
    prop, s_p = _batched(prop, "prop", move_pos.shape, dt, dev, 2)
    if k > 1 and s_p != n * d:         # the kernel reads it as one block
        prop = prop.contiguous()
    lnp_prop, s_q = _batched(lnp_prop, "lnprob_batch's return", rows, dt,
                             dev, 1)
    x, s_x = _batched(move_pos, "move_pos", move_pos.shape, dt, dev, 2)
    lnp, s_0 = _batched(move_lnp, "move_lnp", rows, dt, dev, 1)
    new_pos = move_pos.new_empty(move_pos.shape)
    new_lnp = move_pos.new_empty(rows)
    accept = move_pos.new_empty(rows, dtype=torch.bool)
    rc = getattr(load_library(), f"{name}_launch")(
        u_z.data_ptr(), ln_u.data_ptr(), prop.data_ptr(), lnp_prop.data_ptr(),
        x.data_ptr(), lnp.data_ptr(), new_pos.data_ptr(), new_lnp.data_ptr(),
        accept.data_ptr(), k, n, d, s_u, s_l, s_q, s_x, s_0, a - 1.0,
        1.0 / a, ndim - 1.0, dt is torch.float64,
        torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return new_pos, new_lnp, accept


stretch_propose = wrapper(
    "stretch_propose", stretch_propose_reference, _launch_propose,
    "The stretch proposals of the moving half, ``(move_pos (..., n, D), "
    "other_pos (..., m, D), u_z, j, a)`` -> a fresh (..., n, D) tensor.")
stretch_accept = wrapper(
    "stretch_accept", stretch_accept_reference, _launch_accept,
    "The stretch move's accept step, ``(prop, lnp_prop, move_pos, "
    "move_lnp, u_z, ln_u, a, ndim)`` -> fresh ``(new_pos, new_lnp, "
    "accept)``.")
