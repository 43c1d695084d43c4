"""The information-criteria subcommands (port of
``lumfuncmcmc_tpu/cli/ic_cmds.py``): ``compare-ic``, the paired model
comparison, and ``stack-ic``, the stacking weights, over ``--ic``
pointwise artifacts. Both read only ``.npz`` files and run on the CPU."""

from __future__ import annotations

import numpy as np


def cmd_compare_ic(args):
    """Paired model comparison of two ``ic_pointwise`` artifacts (the
    same catalog, as the paired-shape check enforces)."""
    from lumfuncmcmc_tpu_torch.models.ic import compare_ic
    a = dict(np.load(args.npz_a))
    b = dict(np.load(args.npz_b))
    r = None
    for which in ("loo", "waic"):
        res = compare_ic(a, b, which=which)
        if which == "loo":
            r = res
        print(f"elpd_{which}(A) - elpd_{which}(B) = "
              f"{res['delta']:+.3f} +- {res['se']:.3f}  "
              f"(z = {res['z']:+.2f}, {res['n_sources']} paired "
              "sources)")
    verdict = {"a": f"model A ({args.npz_a}) is preferred",
               "b": f"model B ({args.npz_b}) is preferred",
               "tie": "no significant preference (|z| <= 2)"}
    kmax = float(max(a["pareto_k"].max(), b["pareto_k"].max()))
    if kmax > 0.7:
        print(f"WARNING: max Pareto k = {kmax:.2f} > 0.7 — some LOO "
              "columns are unreliable; weigh the WAIC line more")
    print(verdict[r["preferred"]])
    return 0


def cmd_stack_ic(args):
    """Stacking weights over K models' pointwise-elpd artifacts: the
    optimal predictive mixture, not just a pairwise ranking (float64 on
    the CPU)."""
    from lumfuncmcmc_tpu_torch.models.ic import stacking_weights
    if len(args.npz) < 2:
        print("stack-ic needs at least 2 ic_pointwise npz files")
        return 1
    cols = []
    for p in args.npz:
        cols.append(np.asarray(np.load(p)["elpd_loo_i"], dtype=np.float64))
        if cols[-1].shape != cols[0].shape:
            raise ValueError(
                f"stacking needs the same sources: {args.npz[0]} has "
                f"{cols[0].shape[0]} pointwise terms, {p} "
                f"{cols[-1].shape[0]} — were all fits run on the same "
                "catalog?")
    w, info = stacking_weights(np.column_stack(cols))
    for i, p in enumerate(args.npz):
        print(f"  w={w[i]:.4f}  (pseudo-BMA {info['pseudo_bma'][i]:.4f},"
              f" elpd_loo {info['log_score_single'][i]:.3f})  {p}")
    print(f"stacked log score {info['log_score']:.3f} vs best single "
          f"{info['log_score_single'].max():.3f} "
          f"({len(cols[0])} paired sources)")
    return 0
