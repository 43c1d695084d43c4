"""Float32 operations and bytes of one call of the free-completeness
kernels, resident (``free_lnlike``, ``free_lnlike_vg``) or streaming
(``free_stream_lnlike``, ``free_stream_lnlike_vg``), from the family and
the shapes alone: W walker rows, the grid's cells, the catalog's valid
sources and its fields. Nothing here reads the kernel, its tiles, its
piece or run tables, or its padding, so any kernel that computes the same
function is held to the same bound.

The function, per walker row, in the factored form every kernel of the
family reads (``a = ln10 (logL - lref)``, ``P = 10^(logL - lref)``, ``R =
10^(logf + 16)``): each grid cell reads (logf, a, P, R, w) and adds
phi * Omega * w; each source reads (logf, a, P, R, mask, field) on the
resident layout and (logf, R, mask) on the streaming one, whose affine
source terms are collapsed on the host. Operations per cell and source
(an FMA 2, each exp, log, rsqrt, divide, max or compare 1): value 23 and
23, value+gradient 46 and 45; streaming value 23 and 15, value+gradient
46 and 33. Each input is read once and each output written once: 6+2F
float32 features a row in, one float64 value a row (7+2F with the
gradient) out.
"""

OPS = {"free_lnlike": (23, 23), "free_lnlike_vg": (46, 45),
       "free_stream_lnlike": (23, 15), "free_stream_lnlike_vg": (46, 33)}


def counts(kernel: str, rows: int, cells: int, sources: int,
           fields: int) -> tuple:
    """``(float32 operations, bytes)`` of one call of ``kernel``."""
    per_cell, per_src = OPS[kernel]
    nfeat = 6 + 2 * fields
    per_src_words = 3 if "stream" in kernel else 6
    out_cols = 1 + nfeat if kernel.endswith("_vg") else 1
    nbytes = (4 * (rows * nfeat + 5 * cells + per_src_words * sources)
              + 8 * rows * out_cols)
    ops = rows * (cells * per_cell + sources * per_src)
    return ops, nbytes
