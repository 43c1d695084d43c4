"""Arithmetic shared by the drivers' checks that decide ``correct``: the
gaps of the program's lnp values against the plain float64 reference's.
Every number a check gives is a gap or a count that a sound run keeps
small; each cell's limits are in ``portbench/limits/<cell>.json``.

- ``nonfinite_rows``: rows that one side gives a finite lnp and the
  other does not (limit 0).
- ``dlnp_gap``: the widest spread of program minus reference over the
  rows in the posterior's bulk: the largest error in the lnp difference
  of two rows, which is what an accept step reads. A row is in the bulk
  where its program lnp or its reference lnp ranks in the middle half of
  that side's values: a walker stranded far out (|lnp| ~ 1e9) has a
  float32 spacing of ~64 there, which no accept step in the bulk reads,
  and a row that either side puts in the bulk is held to the other.
- ``lnp_rel_gap``: the worst row's ``|lnp_program - lnp_reference| /
  max(|lnp_reference|, 1)``, bulk or not.
"""

from __future__ import annotations

import math

import numpy as np


def _middle_half(x):
    """Rows of ``x`` whose rank lies in the middle half."""
    rank = np.empty(x.size, dtype=np.int64)
    rank[np.argsort(x, kind="stable")] = np.arange(x.size)
    return (4 * rank >= x.size) & (4 * rank < 3 * x.size)


def value_gaps(prog, ref) -> dict:
    """``nonfinite_rows``, ``dlnp_gap`` and ``lnp_rel_gap`` of program
    against reference lnp values."""
    prog = np.asarray(prog, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    both = np.isfinite(prog) & np.isfinite(ref)
    out = {"nonfinite_rows": float(np.sum(np.isfinite(prog)
                                          != np.isfinite(ref)))}
    p, r = prog[both], ref[both]
    if not p.size:
        return dict(out, dlnp_gap=math.inf, lnp_rel_gap=math.inf)
    bulk = _middle_half(p) | _middle_half(r)
    d = p[bulk] - r[bulk]
    out["dlnp_gap"] = float(d.max() - d.min())
    out["lnp_rel_gap"] = float(np.max(np.abs(p - r)
                                      / np.maximum(np.abs(r), 1.0)))
    return out
