"""The ranks of ``tests/test_torch_grid.py`` and
``tests/test_torch_grid_nuts.py``: gloo processes on the CPU that run the
port's grid paths. They import the port and torch, never
JAX: the test process holds the JAX side.

:class:`RankPool` starts ``world`` ranks once (``torch.multiprocessing``
spawn) and feeds them cases through a queue each; every rank runs the
case (a function of :data:`CASES`) and returns its result, numpy arrays
and numbers. A case that raises on any rank raises in the test process
with every rank's traceback; the process group's timeout bounds a rank
that waits in a collective for a rank that raised.
"""

from __future__ import annotations

import contextlib
import os
import queue
import socket
import traceback

import numpy as np

TIMEOUT = 60.0      # seconds a collective or a case may wait


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_grid_flags(main, args, out, base, extra=()):
    """The grid flags through the CLI ``main`` in one process:
    ``--mesh-walkers 1`` and ``--distributed host:port,1,0`` (a grid of
    one gloo rank) write the meshless run's fitposterior (``p.dat``'s,
    already in ``out``) byte for byte, and ``--mesh-walkers 2`` on one
    rank raises naming the ranks it needs."""
    import pytest
    want = (out / f"fitposterior_p_{base}.dat").read_bytes()
    for name, flag in (("m", ["--mesh-walkers", "1"]),
                       ("g", ["--distributed",
                              f"127.0.0.1:{_free_port()},1,0"])):
        assert main([a.replace("p.dat", f"{name}.dat") for a in args]
                    + flag + list(extra)) == 0
        assert (out / f"fitposterior_{name}_{base}.dat").read_bytes() == want
    with pytest.raises(ValueError, match="needs 2 devices"):
        main([a.replace("p.dat", "q.dat") for a in args]
             + ["--mesh-walkers", "2"] + list(extra))


class RankPool:
    """``world`` gloo ranks, started once, each with a queue of cases.
    ``env``: variables the ranks start with (their own torch reads them
    when it first dispatches)."""

    def __init__(self, world: int, env=None):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        port = _free_port()
        self.world = world
        self.outq = ctx.Queue()
        self.inqs = [ctx.Queue() for _ in range(world)]
        self.procs = [ctx.Process(target=rank_main, daemon=True,
                                  args=(r, world, port, self.inqs[r],
                                        self.outq))
                      for r in range(world)]
        saved = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        try:
            for p in self.procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v

    def run(self, case: str, timeout: float = 2 * TIMEOUT, **kw) -> list:
        """Every rank's result of ``CASES[case](**kw)``, by rank."""
        for q in self.inqs:
            q.put((case, kw))
        got = {}
        while len(got) < self.world:
            try:
                r, status, value = self.outq.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"{case}: ranks {sorted(got)} of "
                                   f"{self.world} answered") from None
            got[r] = (status, value)
        errs = [f"rank {r}:\n{v}" for r, (st, v) in sorted(got.items())
                if st != "ok"]
        if errs:
            raise RuntimeError(f"{case} failed\n" + "\n".join(errs))
        return [got[r][1] for r in range(self.world)]

    def close(self):
        for q in self.inqs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=TIMEOUT)
            if p.is_alive():
                p.kill()


def rank_main(rank, world, port, inq, outq):
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    torch.set_num_threads(1)
    from lumfuncmcmc_tpu_torch.parallel.distributed import (
        init_distributed, shutdown)
    init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                     timeout=TIMEOUT)
    while True:
        msg = inq.get()
        if msg is None:
            break
        case, kw = msg
        try:
            outq.put((rank, "ok", CASES[case](**kw)))
        except BaseException:
            outq.put((rank, "err", traceback.format_exc()))
    shutdown()


# ---------------------------------------------------------------------------
# the cases (each runs on every rank)
# ---------------------------------------------------------------------------

def _ctx_layout(arrays, cfg_kw, model):
    import torch

    from lumfuncmcmc_tpu_torch import LFConfig
    from lumfuncmcmc_tpu_torch.models.context import context_from_arrays
    from lumfuncmcmc_tpu_torch.models.hierarchical import ThetaLayoutH
    from lumfuncmcmc_tpu_torch.models.likelihood import ThetaLayout
    from lumfuncmcmc_tpu_torch.models.likelihood_z import ThetaLayoutZ
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    cls = {"z": ThetaLayoutZ, "hier": ThetaLayoutH}.get(model, ThetaLayout)
    return ctx, cls.from_config(LFConfig(**cfg_kw))


def _grid_lnprob(route, ctx, layout, grid, model, exact_bounds=False):
    from lumfuncmcmc_tpu_torch.parallel import sharding as sh
    if route == "eager":
        return sh.make_lnprob_sharded(ctx, layout, grid, model=model,
                                      exact_bounds=exact_bounds)
    if route == "cuda":
        return sh.make_cuda_lnprob_sharded(ctx, layout, grid, model=model)
    return sh.make_cuda_lnprob_stream_sharded(ctx, layout, grid)


def case_lnprob(arrays, cfg_kw, model, shape, thetas, route="eager",
                exact_bounds=False):
    """The grid's lnprob of ``thetas`` by ``route``."""
    import torch

    from lumfuncmcmc_tpu_torch.parallel.mesh import make_mesh
    ctx, layout = _ctx_layout(arrays, cfg_kw, model)
    fn = _grid_lnprob(route, ctx, layout, make_mesh(*shape), model,
                      exact_bounds)
    return {"lnp": fn(torch.as_tensor(thetas)).numpy(),
            "engine": getattr(fn, "engine", "eager")}


def case_stretch(arrays, cfg_kw, shape, move, nsteps, nwalkers,
                 route="eager", seed=3):
    """A stretch run on the grid's lnprob and, on the same generator
    seed, the meshless one: ``run_stretch`` both."""
    import torch

    from lumfuncmcmc_tpu_torch.models.likelihood import (
        make_lnprob, sample_init)
    from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
    from lumfuncmcmc_tpu_torch.parallel.mesh import make_mesh
    from lumfuncmcmc_tpu_torch.samplers.affine import run_stretch
    ctx, layout = _ctx_layout(arrays, cfg_kw, "single")
    fn = _grid_lnprob(route, ctx, layout, make_mesh(*shape), "single")
    meshless = (make_lnprob(ctx, layout) if route == "eager"
                else cl.make_cuda_lnprob(ctx, layout))
    rows = []

    def counted(th):
        rows.append(th.shape[0])
        return fn(th)

    out = {}
    for name, lnp in (("grid", counted), ("meshless", meshless)):
        gen = torch.Generator().manual_seed(seed)
        pos0 = sample_init(gen, layout, nwalkers)
        _, chain, lnps, acc = run_stretch(lnp, pos0, gen, nsteps, move=move,
                                          de_prob=0.4)
        out[name] = (chain.numpy(), lnps.numpy(), acc.numpy())
    out["rows"] = rows
    return out


def _lnp_gauss(x):
    import torch
    prec = torch.tensor([[2.0, 0.6, 0.0], [0.6, 1.0, 0.3], [0.0, 0.3, 0.5]],
                        dtype=x.dtype)
    return -0.5 * torch.einsum("wi,ij,wj->w", x, prec, x)


def case_ensembles(pos0, move, nsteps, rands=None, seed=5):
    """``run_stretch_ensembles_sharded`` (or, with numpy ``rands``, its
    pre-drawn form) on a (world, 1) grid, with the meshless twin on the
    same generator; the rows of each lnprob call."""
    import torch

    from lumfuncmcmc_tpu_torch.parallel import sharding as sh
    from lumfuncmcmc_tpu_torch.parallel.distributed import world_size
    from lumfuncmcmc_tpu_torch.parallel.mesh import make_mesh
    from lumfuncmcmc_tpu_torch.samplers import affine as taff
    grid = make_mesh(world_size(), 1)
    rows = []

    def counted(th):
        rows.append(th.shape[0])
        return _lnp_gauss(th)

    p0 = torch.as_tensor(pos0)
    if rands is not None:
        t = _tensors(rands)
        st, ch, lp, acc = sh.run_ensembles_sharded_with(
            counted, p0, t, nsteps, grid, move=move)
        return {"chain": ch.numpy(), "lnp": lp.numpy(), "acc": acc.numpy(),
                "pos": st.pos.numpy(), "rows": rows}
    gen = torch.Generator().manual_seed(seed)
    st, ch, lp, acc = sh.run_stretch_ensembles_sharded(
        counted, p0, gen, nsteps, grid, move=move, de_prob=0.4, thin=2)
    gen = torch.Generator().manual_seed(seed)
    mst, mch, mlp, macc = taff.run_stretch_ensembles(
        _lnp_gauss, p0, gen, nsteps, move=move, de_prob=0.4, thin=2)
    return {"grid": (ch.numpy(), lp.numpy(), acc.numpy(), st.pos.numpy()),
            "meshless": (mch.numpy(), mlp.numpy(), macc.numpy(),
                         mst.pos.numpy()), "rows": rows}


def _tensors(x):
    import torch
    if isinstance(x, np.ndarray) and x.dtype != bool:
        return torch.as_tensor(x)
    if isinstance(x, (list, tuple)):
        return tuple(_tensors(v) for v in x)
    return x


HALF = 6.0


def _prior_box(th):
    import torch
    ok = torch.all(th.abs() < HALF, dim=1)
    return torch.where(ok, torch.zeros_like(th[:, 0]),
                       torch.full_like(th[:, 0], -np.inf))


def _like_gauss(th):
    import torch
    mu = torch.tensor([0.3, -0.4, 1.0], dtype=th.dtype)
    sd = torch.tensor([1.0, 0.5, 2.0], dtype=th.dtype)
    return -0.5 * (((th - mu) / sd) ** 2).sum(dim=1)


def case_ladder(pos0, betas, nsteps, move, swap_every=0, seed=7):
    """The grid's ladder (``run_tempered_sharded``, or with
    ``swap_every`` ``run_parallel_tempering_sharded``) beside the
    meshless one on the same generator seed, and the sharded PT's
    ``_with`` form on that seed's draws (its swaps)."""
    import torch

    from lumfuncmcmc_tpu_torch.parallel import sharding as sh
    from lumfuncmcmc_tpu_torch.parallel.distributed import world_size
    from lumfuncmcmc_tpu_torch.parallel.mesh import make_mesh
    from lumfuncmcmc_tpu_torch.samplers import tempering as tt
    grid = make_mesh(world_size(), 1)
    p0 = torch.as_tensor(pos0)
    out = {}
    for name in ("grid", "meshless"):
        gen = torch.Generator().manual_seed(seed)
        if swap_every:
            args = (_prior_box, _like_gauss, p0, betas, gen, nsteps)
            res = (sh.run_parallel_tempering_sharded(
                *args, grid, swap_every=swap_every, move=move)
                if name == "grid" else tt.run_parallel_tempering(
                    *args, swap_every=swap_every, move=move))
        else:
            args = (_prior_box, _like_gauss, p0, betas, gen, nsteps)
            res = (sh.run_tempered_sharded(*args, grid, move=move)
                   if name == "grid" else tt.run_tempered(*args, move=move))
        out[name] = [r if isinstance(r, np.ndarray) else r.numpy()
                     for r in res]
    if swap_every:
        K, W, D = p0.shape
        n = nsteps // swap_every * swap_every
        gen = torch.Generator().manual_seed(seed)
        rands = tt.ladder_rands(gen, K, n, W, D, p0.dtype, "cpu", move)
        u = torch.rand((n // swap_every, K - 1, W), generator=gen,
                       dtype=p0.dtype)
        *_, swaps = sh.run_parallel_tempering_sharded_with(
            _prior_box, _like_gauss, p0, betas, rands, u, n, grid,
            swap_every=swap_every, move=move)
        out["swaps"] = swaps.numpy()
        out["u"] = u.numpy()
    return out


def _model(arrays_cfg, shape, **over):
    """A ``LumFuncModel`` on the synthetic catalog ``arrays_cfg`` (its
    ``make_catalog`` arrays and config knobs) on a ``shape`` grid."""
    import torch

    from lumfuncmcmc_tpu_torch import LFConfig
    from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
    cat, kw = arrays_cfg
    cfg = LFConfig(**{**kw, **over, "mesh_walkers": shape[0],
                      "mesh_sources": shape[1]})
    return LumFuncModel(cfg, z=cat["z"], flux=cat["flux"],
                        flux_e=cat["flux_e"], field_id=cat["field_id"],
                        device="cpu", dtype=torch.float64)


def case_fit_checkpoint(arrays_cfg, shape, path, resume, cut=None):
    """A checkpointed ``fit_model`` on the grid (blocks of 10 steps) and
    the ``np.savez`` calls this rank made; with ``cut`` (blocks) rank 0
    first cuts the npz at ``path`` to that many blocks, as a kill would
    have left it, and every rank resumes from it (a shared disk)."""
    import torch.distributed as dist
    m = _model(arrays_cfg, shape, checkpoint_every=10)
    if cut is not None and dist.get_rank() == 0:
        with np.load(path) as ck:
            d = {k: ck[k] for k in ck.files}
        np.savez(path, chain=d["chain"][:10 * cut],
                 lnprobability=d["lnprobability"][:10 * cut],
                 acc_blocks=d["acc_blocks"][:cut],
                 fingerprint=d["fingerprint"])
    dist.barrier()
    saves, savez = [], np.savez

    def counted(*a, **kw):
        saves.append(a[0])
        return savez(*a, **kw)

    np.savez = counted
    try:
        m.fit_model(checkpoint_path=path, resume=resume)
    finally:
        np.savez = savez
    dist.barrier()
    return {"chain": m.chain, "samples": m.samples,
            "acc": m.acceptance_fraction, "saves": len(saves)}


def case_resume_mismatch(arrays_cfg, shape, path):
    """Every rank resumes, rank 1 from a file the others do not see."""
    import torch.distributed as dist
    m = _model(arrays_cfg, shape, checkpoint_every=10)
    mine = path if dist.get_rank() != 1 else path + ".absent.npz"
    try:
        m.fit_model(checkpoint_path=mine, resume=True)
    except RuntimeError as e:
        return str(e)
    return "no error"


def case_model(arrays_cfg, shape, what, over=None, **kw):
    """A model method on the grid: ``evidence`` (``log_evidence``),
    ``ensembles`` (``fit_model_ensembles``) or ``nuts``
    (``fit_model_nuts``, ``md`` its tree depth); ``over``: config
    fields."""
    m = _model(arrays_cfg, shape, **(over or {}))
    if what == "evidence":
        ev = m.log_evidence(**kw)
        return {k: ev[k] for k in ("lnz_ss", "lnz_ti", "nrungs",
                                   "mean_lnl")} | (
            {"swap_frac": ev["swap_frac"]} if "swap_frac" in ev else {})
    if what == "ensembles":
        m.fit_model_ensembles(**kw)
        return {"samples": m.samples, "rhat": m.rhat_ensembles}
    with _depth(kw.pop("md", None)):
        m.fit_model_nuts(**kw)
    return {"samples": m.samples}


@contextlib.contextmanager
def _depth(md):
    """The driver's NUTS tree depth set to ``md`` (None: kept)."""
    from lumfuncmcmc_tpu_torch.models import nuts_driver as nd
    depth = nd.MAX_DOUBLINGS
    nd.MAX_DOUBLINGS = md or depth
    try:
        yield
    finally:
        nd.MAX_DOUBLINGS = depth


def case_cli(argv, workdir, max_doublings=None):
    """The port's CLI in ``workdir``/rank<r> on every rank: its exit code
    and the files each rank wrote there. ``max_doublings``: the NUTS
    tree depth of the run (the driver's ``MAX_DOUBLINGS``)."""
    import torch.distributed as dist

    from lumfuncmcmc_tpu_torch.cli.main import main
    d = os.path.join(workdir, f"rank{dist.get_rank()}")
    os.makedirs(d, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        with _depth(max_doublings):
            rc = main(list(argv))
    finally:
        os.chdir(cwd)
    files = sorted(os.path.relpath(os.path.join(p, f), d)
                   for p, _, fs in os.walk(d) for f in fs)
    return {"rc": rc, "files": files}


def _nuts_post(ctx, layout, grid, route):
    """The per-rank lnprob NUTS differentiates on ``route``: the eager
    engine ("eager"), the value+gradient kernels' plain versions
    ("kernel") or the streaming route's source-summed one ("stream")."""
    from lumfuncmcmc_tpu_torch.models.likelihood import make_lnprob
    from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
    from lumfuncmcmc_tpu_torch.parallel import sharding as sh
    if route == "eager":
        return make_lnprob(ctx, layout)
    if route == "kernel":
        return cl.make_cuda_lnprob_and_grad(ctx, layout)
    return sh.make_cuda_lnprob_and_grad_stream_sharded(ctx, layout, grid)


def case_nuts(arrays, cfg_kw, shape, y0, route="kernel", pooled=True,
              axis="walkers", warmup=40, samples=12, md=5, seed=3,
              meshless=False, blocks=False, cont=0):
    """``run_nuts_sharded`` (``run_nuts_stream_sharded`` on the "stream"
    route) on the grid from the (C, D) starts ``y0``; with ``meshless``
    rank 0 also runs ``run_nuts`` on the same seed, with ``blocks`` every
    rank runs ``run_nuts_with`` on its block of chains and their rows of
    the same draws, unpooled, and with ``cont`` the run is continued by
    that many samples (``continue_nuts_stream_sharded``)."""
    import torch

    from lumfuncmcmc_tpu_torch.parallel import sharding as sh
    from lumfuncmcmc_tpu_torch.parallel.mesh import make_mesh
    from lumfuncmcmc_tpu_torch.samplers import nuts as tn
    ctx, layout = _ctx_layout(arrays, cfg_kw, "single")
    grid = make_mesh(*shape)
    lo, hi = layout.bounds_arrays(torch.float64, "cpu")
    lnp_y = tn.make_unconstrained(_nuts_post(ctx, layout, grid, route), lo,
                                  hi)[0]
    y0 = torch.as_tensor(y0)
    gen = torch.Generator().manual_seed(seed)
    if route == "stream":
        run = sh.run_nuts_stream_sharded(ctx, layout, grid, y0, gen, warmup,
                                         samples, pooled=pooled,
                                         max_doublings=md)
    else:
        run = sh.run_nuts_sharded(lnp_y, y0, gen, grid, warmup, samples,
                                  pooled=pooled, axis=axis,
                                  max_doublings=md)
    out = {"eps": run.eps.numpy(), "state_eps": run.state[1].numpy(),
           "counts": (run.counts.transitions, run.counts.leapfrogs)}
    if cont:
        more = sh.continue_nuts_stream_sharded(ctx, layout, grid, run.state,
                                               gen, cont, max_doublings=md)
        out["cont"] = more.samples.numpy()
    if grid.rank == 0:
        out.update(samples=run.samples.numpy(), lnps=run.lnps.numpy(),
                   alphas=run.alphas.numpy(),
                   state=[x.numpy() for x in run.state])
    if meshless and grid.rank == 0:
        ref = tn.run_nuts(lnp_y, y0, torch.Generator().manual_seed(seed),
                          warmup, samples, max_doublings=md)
        out["meshless"] = (ref.samples.numpy(), ref.lnps.numpy(),
                           ref.alphas.numpy(), float(ref.eps),
                           ref.scale.numpy())
    if blocks:
        n, i, _ = sh.nuts_axis(grid, axis)
        b = y0.shape[0] // n
        draw = tn.generator_draw(torch.Generator().manual_seed(seed),
                                 y0.shape[0], y0.shape[1], md, y0.dtype,
                                 "cpu")
        ref = tn.run_nuts_with(tn.block_draw(draw, i * b, (i + 1) * b),
                               lnp_y, y0[i * b:(i + 1) * b], warmup,
                               samples, max_doublings=md)
        out["block"] = (i * b, ref.samples.numpy(), ref.lnps.numpy(),
                        float(ref.eps))
        out["mine"] = run.samples[:, i * b:(i + 1) * b].numpy()
    return out


def case_vg_stream(arrays, cfg_kw, shape, thetas):
    """``make_cuda_vg_stream_sharded`` of ``thetas`` on the grid."""
    import torch

    from lumfuncmcmc_tpu_torch.parallel import sharding as sh
    from lumfuncmcmc_tpu_torch.parallel.mesh import make_mesh
    ctx, layout = _ctx_layout(arrays, cfg_kw, "single")
    fn = sh.make_cuda_vg_stream_sharded(ctx, layout, make_mesh(*shape))
    v, g = fn(torch.as_tensor(thetas))
    return {"v": v.numpy(), "g": g.numpy(), "engine": fn.engine,
            "shards": fn.source_shards}


def case_nuts_fit(arrays_cfg, shape, path=None, resume=False, cut=None,
                  stream=False, **kw):
    """``fit_model_nuts`` of the model on the grid (``kw`` its arguments
    and, by ``cfg_`` prefix, config fields), checkpointed at ``path``;
    with ``cut`` (blocks) rank 0 first cuts the npz there to that many
    blocks, as a kill would have left it, and every rank resumes from it
    (a shared disk; ``chip_smoke.py``'s cut). ``stream``: the streaming
    route's source-count gate
    lowered to 0. Returns the chain, the samples, the log lines of the
    route and this rank's ``np.savez`` calls."""
    import logging

    import torch.distributed as dist

    from chip_smoke import _cut_npz
    from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
    over = {k[4:]: kw.pop(k) for k in list(kw) if k.startswith("cfg_")}
    gate = cl.STREAM_MIN_SOURCES
    cl.STREAM_MIN_SOURCES = 0 if stream else gate
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log = logging.getLogger("lumfuncmcmc_tpu_torch")
    keep = Keep()
    log.addHandler(keep)
    saves, savez = [], np.savez

    def counted(*a, **k):
        saves.append(a[0])
        return savez(*a, **k)

    try:
        m = _model(arrays_cfg, shape, **over)
        if cut is not None and dist.is_initialized():
            if dist.get_rank() == 0:
                _cut_npz(path, path, cut)
            dist.barrier()
        elif cut is not None:
            _cut_npz(path, path, cut)
        np.savez = counted
        with _depth(kw.pop("max_doublings", None)):
            m.fit_model_nuts(checkpoint_path=path, resume=resume, **kw)
    finally:
        np.savez = savez
        cl.STREAM_MIN_SOURCES = gate
        log.removeHandler(keep)
    if dist.is_initialized():
        dist.barrier()
    return {"chain": m.chain, "samples": m.samples, "saves": len(saves),
            "lines": [ln for ln in lines if ln.startswith("NUTS")]}


def case_smoke():
    from lumfuncmcmc_tpu_torch.parallel.distributed import smoke_check
    return smoke_check()


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}
