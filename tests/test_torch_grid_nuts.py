"""PyTorch port vs JAX package: NUTS on the device grid (``parallel/``
and ``models/nuts_driver.py``) on gloo ranks on the CPU, float64.

The ranks (``tests/torch_grid_worker.py``: pools of 1, 2 and 4, started
once for the module) import no JAX; this process runs the JAX side on
its 8 virtual CPU devices. They run ATen's portable kernels
(``ATEN_CPU_CAPABILITY=default``): the SIMD kernels take the last ``n mod
2V`` elements of a tensor through the scalar libm path, so the bits of a
chain's exp or log there would depend on its place in the batch, and a
block of the chains could not reproduce the batch. Every bit-for-bit
comparison is between ranks of these pools (a pool of one rank runs the
meshless path). Cases are named after their JAX twins in
``tests/test_sharding.py`` and ``tests/test_distributed.py``:

- pooled NUTS on (2,1) and (4,1) against the meshless ``run_nuts`` on
  the same seed, bit for bit (``:88``);
- the per-rank replicas: each rank's block against ``run_nuts_with`` of
  that block on its rows of the same draws, bit for bit; the pooled
  replicas the meshless run bit for bit, one step size on every rank;
  the replicas' medians within 0.5 of the meshless run's (``:286,429``);
- the streaming value+gradient on source shards, (1,2) and (2,2) with an
  odd walker count, against the meshless streaming one (1e-10) and JAX's
  ``make_pallas_vg_stream_sharded`` in interpret mode on a mesh of the
  same shape (``:345,370``), and a streaming NUTS run (``:399``);
- elastic checkpoints: a fixed-length replica run written on (2,1) and a
  min-ess pooled run written on (4,1) resume bit for bit on one rank and
  on (2,2); a streaming checkpoint refuses another source count
  (``:647,721,853,919``); the two-rank min-ess checkpoint
  (``tests/test_distributed.py:285``);
- the route of each configuration against JAX's choice;
- ``fit``, ``fit -fc``, ``fitz`` and ``fith --sampler nuts`` through the
  CLI on 2 ranks: rank 0 alone writes, the one-process run's artifacts
  byte for byte; ``fit_model_nuts`` on (4,1) and the CLI's ``--sampler
  nuts`` on 2 ranks with ``--nuts-pooled``, which the grid refused before.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.parallel.mesh import make_mesh as jax_mesh
from lumfuncmcmc_tpu_torch import LFConfig as PortConfig
from lumfuncmcmc_tpu_torch.models import nuts_driver as nd
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.samplers import nuts as tn
from lumfuncmcmc_tpu_torch.utils import synth
from tests.torch_grid_worker import RankPool
from tests.torch_mc_cases import _arrays, case, central

PORTABLE = {"ATEN_CPU_CAPABILITY": "default", "OMP_NUM_THREADS": "1"}
NCH, WARM, SAMP = 8, 40, 12


@pytest.fixture(scope="module")
def pools():
    made = {}

    def pool(world):
        if world not in made:
            made[world] = RankPool(world, env=PORTABLE)
        return made[world]

    yield pool
    for p in made.values():
        p.close()


def _family(fam, size_ln=11, n=250):
    c = case(fam, size_ln=size_ln, n=n)
    return c, _arrays(c.jctx), dict(min_comp_frac=0.5, size_ln=size_ln,
                                    fix_comp=fam != "free")


def _y0(c, seed=2):
    """Starts in the posterior's bulk, so that short runs sample it: the
    catalog's true theta, jittered by 1% of the box, in the unconstrained
    coordinates."""
    tt = c.cat["theta_true"]
    truth = [tt["Lstar"], tt["phistar"], tt["sch_al"]]
    if c.play.ndim > 3:
        truth += list(c.jcfg.Flim) + [c.jcfg.alpha]
    lo, hi = c.play.bounds_arrays(torch.float64, "cpu")
    _, _, to_y = tn.make_unconstrained(None, lo, hi)
    rng = np.random.default_rng(seed)
    th = (torch.as_tensor(truth) + 0.01 * (hi - lo)
          * torch.as_tensor(rng.normal(size=(NCH, c.play.ndim))))
    return to_y(th).numpy()


def _nuts(pool, fam, shape, **kw):
    c, arrays, cfg_kw = _family(fam)
    return pool.run("nuts", arrays=arrays, cfg_kw=cfg_kw, shape=shape,
                    y0=_y0(c), **{"warmup": WARM, "samples": SAMP, **kw})


@pytest.mark.parametrize("shape", [(2, 1), (4, 1)])
def test_nuts_on_mesh_matches_unsharded(pools, shape):
    got = _nuts(pools(shape[0]), "fixed", shape, pooled=True,
                axis="walkers", md=3, meshless=True)
    s, lp, al, eps, scale = got[0]["meshless"]
    np.testing.assert_array_equal(got[0]["samples"], s)
    np.testing.assert_array_equal(got[0]["lnps"], lp)
    np.testing.assert_array_equal(got[0]["alphas"], al)
    y_run, eps_c, scale_c = got[0]["state"]
    assert np.all(eps_c == eps) and np.all(scale_c == scale[None, :])
    for g in got:
        assert np.all(g["eps"] == eps)
    # each rank ran its own trajectories: fewer batched leapfrogs
    assert all(g["counts"][0] == WARM + SAMP for g in got)


@pytest.fixture(scope="module")
def free_runs(pools):
    """The free family's replicas on (2,1), pooled and not: the first with
    the meshless run beside it, the second with each rank's block."""
    pool = pools(2)
    kw = dict(route="kernel", axis="grid", md=3)
    return (_nuts(pool, "free", (2, 1), pooled=True, meshless=True, **kw),
            _nuts(pool, "free", (2, 1), pooled=False, blocks=True, **kw))


def test_run_nuts_sharded_pooled_shares_eps(free_runs):
    pooled, _ = free_runs
    s, lp, _, eps, _ = pooled[0]["meshless"]
    np.testing.assert_array_equal(pooled[0]["samples"], s)
    np.testing.assert_array_equal(pooled[0]["lnps"], lp)
    assert [float(g["eps"][0]) for g in pooled] == [eps, eps]
    assert np.all(pooled[0]["state_eps"] == eps)


def test_nuts_native_mesh_replicas(free_runs):
    pooled, replicas = free_runs
    for g in replicas:
        c0, s, lp, eps = g["block"]
        np.testing.assert_array_equal(g["mine"], s)
        blk = s.shape[1]
        np.testing.assert_array_equal(replicas[0]["lnps"][:, c0:c0 + blk],
                                      lp)
        # each chain carries its own rank's step size
        assert np.all(g["state_eps"][c0:c0 + blk] == eps)
        np.testing.assert_array_equal(g["eps"], replicas[0]["eps"])
    c, _, _ = _family("free")
    lo, hi = c.play.bounds_arrays(torch.float64, "cpu")
    _, to_theta, _ = tn.make_unconstrained(None, lo, hi)

    def medians(y):
        th = to_theta(torch.as_tensor(y).reshape(-1, y.shape[-1]))
        return np.median(th.numpy()[:, :3], axis=0)
    np.testing.assert_allclose(medians(replicas[0]["samples"]),
                               medians(pooled[0]["meshless"][0]), atol=0.5)


def _jax_stream_vg(c, shape, th):
    from lumfuncmcmc_tpu.parallel.sharding import (
        make_pallas_vg_stream_sharded)
    fn = make_pallas_vg_stream_sharded(c.jctx, c.jlay, jax_mesh(*shape),
                                       interpret=True)
    v, g = fn(jnp.asarray(th, jnp.float32))
    return np.asarray(v, np.float64), np.asarray(g, np.float64)


def _grad_close(gp, gref, rtol):
    """The JAX package's gradient bar (tests/test_pallas.py)."""
    denom = np.maximum(np.abs(gref),
                       1e-3 * np.abs(gref).max(axis=-1, keepdims=True))
    np.testing.assert_array_less(np.abs(gp - gref) / denom, rtol)


@pytest.mark.parametrize("shape, w", [((1, 2), 6), ((2, 2), 5)])
def test_stream_sharded_vg_matches_xla_grad(pools, shape, w, monkeypatch):
    c, arrays, cfg_kw = _family("free", size_ln=7, n=150)
    th = central(c.play, w, 9)
    got = pools(shape[0] * shape[1]).run(
        "vg_stream", arrays=arrays, cfg_kw=cfg_kw, shape=shape, thetas=th)
    assert got[0]["engine"] == "plain-stream"
    assert got[0]["shards"] == shape[1]
    for g in got[1:]:
        np.testing.assert_array_equal(g["v"], got[0]["v"])
        np.testing.assert_array_equal(g["g"], got[0]["g"])
    v, g = got[0]["v"], got[0]["g"]
    assert v.shape == (w,) and g.shape == (w, c.play.ndim)
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES", 0)
    one = cl.make_cuda_lnprob_and_grad(c.pctx, c.play)
    assert one.engine == "plain-stream"
    v1, g1 = tn.value_and_grad(one)(torch.as_tensor(th))
    np.testing.assert_allclose(v, v1.numpy(), rtol=1e-10)
    _grad_close(g, g1.numpy(), 1e-10)
    if shape != (2, 2):
        return
    # JAX's kernel runs in float32: the JAX package's own bars
    jv, jg = _jax_stream_vg(c, shape, th)
    np.testing.assert_allclose(v, jv, rtol=5e-4)
    _grad_close(g, jg, 2e-3)


def test_run_nuts_stream_sharded(pools):
    kw = dict(route="stream", pooled=True, axis="walkers", md=3, warmup=10)
    got = _nuts(pools(4), "free", (2, 2), samples=3, cont=3, **kw)
    whole = _nuts(pools(4), "free", (2, 2), samples=6, **kw)
    # continued by 3 samples, the 3-sample run is the 6-sample one
    np.testing.assert_array_equal(
        np.concatenate([got[0]["samples"], got[0]["cont"]]),
        whole[0]["samples"])
    got = whole
    # the source ranks of a walker rank ran the same chains on the same
    # bits; the walker ranks pooled one step size
    assert got[0]["samples"].shape == (6, NCH, 9)
    assert np.all(np.isfinite(got[0]["lnps"]))
    assert all(np.all(g["eps"] == got[0]["eps"][0]) for g in got)
    for a, b in ((0, 1), (2, 3)):
        assert got[a]["counts"] == got[b]["counts"]


@pytest.fixture(scope="module")
def catalog():
    kw = dict(min_comp_frac=0.5, size_ln=11, nwalkers=8, nsteps=12)
    cfg = PortConfig(**kw)
    cat = synth.apply_completeness_cut(
        synth.make_catalog(cfg, n_target=250, seed=11), cfg)
    return {k: cat[k] for k in ("z", "flux", "flux_e", "field_id")}, kw


def _fit(pool, catalog, shape, path, **kw):
    return pool.run("nuts_fit", arrays_cfg=catalog, shape=shape,
                    path=str(path), **kw)


def test_fit_model_nuts_fixed_ckpt_native_mesh(pools, catalog, tmp_path):
    """A fixed-length replica run (blocks of 4 samples) on (2,1), each
    rank adapting its own step size, cut at one block and resumed on one
    rank (every chain's step size in one block) and on (2,2): the chain
    of the run that did not stop, bit for bit."""
    kw = dict(cfg_use_pallas=True, cfg_checkpoint_every=4, num_warmup=WARM,
              nchains=NCH, max_doublings=3)
    path = tmp_path / "rep.npz"
    full = _fit(pools(2), catalog, (2, 1), path, **kw)
    assert [f["saves"] for f in full] == [3, 0]      # rank 0 alone writes
    assert any("per-rank replicas over the 2-rank grid" in ln
               for ln in full[0]["lines"])
    with np.load(path) as ck:
        eps = ck["eps"]
        saved = {k: ck[k] for k in ck.files}
    assert eps.shape == (NCH,) and eps[0] != eps[-1]
    for shape in ((1, 1), (2, 2)):
        one = tmp_path / f"cut{shape[0]}{shape[1]}.npz"
        np.savez(one, **saved)
        got = _fit(pools(shape[0] * shape[1]), catalog, shape, one,
                   resume=True, cut=1, **kw)
        for g in got:
            np.testing.assert_array_equal(g["chain"], full[0]["chain"])
            np.testing.assert_array_equal(g["samples"], full[0]["samples"])
        assert any("start guard skipped" in ln for ln in got[0]["lines"])


def test_nuts_min_ess_checkpoint_resume_native_mesh(pools, catalog,
                                                    tmp_path):
    """A min-ess run on (4,1) (fixed completeness: the pooled route), cut
    at one block, resumes bit for bit on one rank and on (2,2)."""
    kw = dict(cfg_fix_comp=True, cfg_use_pallas=True, num_warmup=WARM,
              nchains=NCH, min_ess=1e6, max_blocks=3, max_doublings=4)
    path = tmp_path / "ess.npz"
    full = _fit(pools(4), catalog, (4, 1), path, **kw)
    assert [f["saves"] for f in full] == [3, 0, 0, 0]
    assert any("pooled adaptation" in ln for ln in full[0]["lines"])
    with np.load(path) as ck:
        saved = {k: ck[k] for k in ck.files}
    for shape in ((1, 1), (2, 2)):
        one = tmp_path / f"ess{shape[0]}{shape[1]}.npz"
        np.savez(one, **saved)
        got = _fit(pools(shape[0] * shape[1]), catalog, shape, one,
                   resume=True, cut=1, **kw)
        np.testing.assert_array_equal(got[0]["samples"], full[0]["samples"])


def test_fit_model_nuts_fixed_ckpt_stream_mesh(pools, catalog, tmp_path):
    """The streaming route (the source-count gate lowered) on (1,2): its
    checkpoint pins the source ranks, so a resume on one rank or on
    (1,4) fails on every rank, naming the field; on (2,2) it resumes."""
    kw = dict(stream=True, cfg_use_pallas=True, cfg_checkpoint_every=3,
              cfg_nsteps=6, num_warmup=20, nchains=4, max_doublings=3)
    path = tmp_path / "st.npz"
    full = _fit(pools(2), catalog, (1, 2), path, **kw)
    assert any("source-sharded streaming" in ln for ln in full[0]["lines"])
    np.testing.assert_array_equal(full[1]["samples"], full[0]["samples"])
    with np.load(path) as ck:
        saved = {k: ck[k] for k in ck.files}
    for shape, why in (((1, 1), "not written by this port's"),
                       ((1, 4), "mesh_sources: saved 2, current 4")):
        one = tmp_path / f"st{shape[1]}.npz"
        np.savez(one, **saved)
        with pytest.raises(RuntimeError) as err:
            _fit(pools(shape[1]), catalog, shape, one, resume=True, **kw)
        assert str(err.value).count(why) == shape[1], str(err.value)
    one = tmp_path / "st22.npz"
    np.savez(one, **saved)
    got = _fit(pools(4), catalog, (2, 2), one, resume=True, cut=1, **kw)
    np.testing.assert_array_equal(got[0]["samples"], full[0]["samples"])


def test_two_process_nuts_min_ess_checkpoint(pools, catalog, tmp_path):
    """The JAX package's two-process min-ess checkpoint: both ranks run
    the gathers, rank 0 alone writes, and a run stopped after one block
    and resumed is the uninterrupted one."""
    kw = dict(cfg_fix_comp=True, cfg_nsteps=6, cfg_seed=5, num_warmup=30,
              nchains=4, min_ess=1e6, max_doublings=4)
    pool = pools(2)
    full = _fit(pool, catalog, (2, 1), tmp_path / "a.npz", max_blocks=2,
                **kw)
    assert [f["saves"] for f in full] == [2, 0]
    short = _fit(pool, catalog, (2, 1), tmp_path / "b.npz", max_blocks=1,
                 **kw)
    assert [f["saves"] for f in short] == [1, 0]
    again = _fit(pool, catalog, (2, 1), tmp_path / "b.npz", max_blocks=2,
                 resume=True, **kw)
    for g in again:
        np.testing.assert_array_equal(g["samples"], full[0]["samples"])
    assert full[0]["samples"].shape == (2 * 6 * 4, 4)
    with np.load(tmp_path / "b.npz") as ck:
        assert len(ck["sizes"]) == 2


ROUTES = [
    # (label, config knobs, model, grid, chains, mega catalog, route)
    ("free (2,1)", {}, "single", (2, 1), 8, False, "replicas"),
    ("free (2,2)", {}, "single", (2, 2), 8, False, "replicas"),
    ("free mega (1,2)", {}, "single", (1, 2), 8, True, "stream"),
    ("free mega (2,1)", {}, "single", (2, 1), 8, True, "replicas"),
    ("fixed (2,2)", {"fix_comp": True}, "single", (2, 2), 8, False,
     "pooled"),
    ("fixed mega (1,2)", {"fix_comp": True}, "single", (1, 2), 8, True,
     "pooled"),
    ("exact bounds (1,2)", {"exact_bounds": True}, "single", (1, 2), 8,
     True, "pooled"),
    ("z (2,1)", {}, "z", (2, 1), 8, False, "pooled"),
    ("hier (2,1)", {}, "hier", (2, 1), 8, False, "pooled"),
    ("auto, 96 a rank", {"use_pallas": None}, "single", (2, 1), 192,
     False, "pooled"),
    ("auto, 95 a rank", {"use_pallas": None}, "single", (2, 1), 190,
     False, "replicas"),
]


def _jax_route(c, model, shape, knobs, nchains, mega, monkeypatch):
    """JAX's choice: the stream route, else the replicas where the
    gradient post is the Pallas kernel, else the XLA mesh path."""
    import lumfuncmcmc_tpu.ops.pallas_lnlike as pk
    from lumfuncmcmc_tpu.models.model import (
        LumFuncModel, LumFuncModelH, LumFuncModelZ)
    cls = {"single": LumFuncModel, "z": LumFuncModelZ,
           "hier": LumFuncModelH}[model]
    monkeypatch.setattr(pk, "free_comp_over_vmem", lambda ctx: mega)
    cfg = c.jcfg.replace(**{"use_pallas": True, "pallas_interpret": True,
                            "size_ln": 7, **knobs})
    m = cls(cfg, mesh=jax_mesh(*shape), z=c.cat["z"], flux=c.cat["flux"],
            flux_e=c.cat["flux_e"], field_id=c.cat["field_id"])
    if knobs.get("use_pallas", True) is None:
        monkeypatch.setattr(m, "_resolve_use_pallas", lambda: True)
    if m._nuts_stream_mesh_route():
        return "stream", m
    post = m._nuts_gradient_post(m._make_scalar_lnprob(), nchains=nchains)
    return ("replicas" if getattr(post, "engine", None) == "pallas"
            else "pooled"), m


@pytest.mark.parametrize("label, knobs, model, shape, nchains, mega, want",
                         ROUTES, ids=[r[0] for r in ROUTES])
def test_nuts_route_is_the_jax_route(label, knobs, model, shape, nchains,
                                     mega, want, monkeypatch):
    c = case("fixed" if knobs.get("fix_comp") else "free", size_ln=11,
             n=250)
    jax_route, m = _jax_route(c, model, shape, knobs, nchains, mega,
                              monkeypatch)
    assert jax_route == want
    cfg = PortConfig(**{**dict(min_comp_frac=0.5, use_pallas=True),
                        **knobs})
    grid = SimpleNamespace(n_walkers=shape[0], n_sources=shape[1],
                           size=shape[0] * shape[1])
    ncells = int(np.prod(np.asarray(m.ctx.logL_grid).shape))
    nsources = cl.STREAM_MIN_SOURCES if mega else 250
    use = cfg.use_pallas is not False and not cfg.exact_bounds
    assert nd.nuts_route(cfg, model, grid, nchains, ncells, nsources,
                         use) == want
    assert nd.nuts_route(cfg, model, None, nchains, ncells, nsources,
                         use) == "meshless"


CLI = ["--synthetic", "150", "-mcf", "0.5", "-ns", "6", "--size-ln", "7",
       "--device", "cpu", "--use-pallas", "--sampler", "nuts", "-o", "n.dat"]
CLI_RUNS = [("fit", ["--nuts-pooled"], "LFMCMCOut", 8),
            ("fit -fc", [], "LFMCMCOut", 8), ("fitz", [], "LFMCMCzOut", 8),
            ("fith", [], "LFMCMCHOut", 32)]


def _config(tmp_path):
    """No plots, and no settings dump (it holds the process's objects)."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"output_dict": {"parameters": true, "settings": '
                   'false, "fitposterior": true, "bestfitLF": true, '
                   '"VeffLF": true, "triangle plot": false, "image '
                   'format": "png"}}')
    return ["--config", str(cfg)]


@pytest.mark.parametrize("cmd, extra, out, nw", CLI_RUNS,
                         ids=[r[0] for r in CLI_RUNS])
def test_cli_nuts_on_two_ranks_writes_the_one_process_artifacts(
        pools, tmp_path, cmd, extra, out, nw):
    argv = (cmd.split() + CLI + ["-nw", str(nw), "--nchains", "2"]
            + _config(tmp_path) + extra)
    got = pools(2).run("cli", argv=argv + ["--mesh-walkers", "2"],
                       workdir=str(tmp_path / "grid"), max_doublings=2)
    assert [g["rc"] for g in got] == [0, 0]
    assert got[1]["files"] == []                    # rank 0 alone writes
    one = pools(1).run("cli", argv=argv, workdir=str(tmp_path / "one"),
                       max_doublings=2)[0]
    assert one["rc"] == 0
    assert got[0]["files"] == one["files"]
    base = f"n_nb50_nw{nw}_ns6_mcf50"
    assert os.path.join(out, f"fitposterior_{base}.dat") in one["files"]
    for f in one["files"]:
        a = tmp_path / "grid" / "rank0" / f
        b = tmp_path / "one" / "rank0" / f
        assert a.read_bytes() == b.read_bytes(), f


def test_model_nuts_on_the_grid(pools, catalog):
    """``fit_model_nuts(nchains=2)`` on (4,1): the chains rounded up to
    one a walker rank, the pooled route, the one-rank run bit for bit."""
    kw = dict(arrays_cfg=catalog, what="nuts", over={"use_pallas": True},
              nchains=2, num_warmup=10, md=2, pooled=True)
    got = pools(4).run("model", shape=(4, 1), **kw)
    one = pools(1).run("model", shape=(1, 1), **{**kw, "nchains": 4})[0]
    assert one["samples"].shape == (4 * 12, 10)
    for g in got:
        np.testing.assert_array_equal(g["samples"], one["samples"])


def test_cli_runs_nuts_on_two_ranks_and_nuts_pooled(pools, tmp_path):
    """``fit -fc --sampler nuts`` on 2 ranks writes the one-process run's
    artifacts (rank 0 alone), and ``--nuts-pooled`` runs in one process
    (the calls the grid refused before)."""
    argv = ["fit", "--synthetic", "250", "-mcf", "0.5", "-ns", "6", "-nw",
            "8", "--size-ln", "7", "--device", "cpu", "--use-pallas", "-o",
            "n.dat"] + _config(tmp_path) + ["--sampler", "nuts", "-fc",
                                            "--nchains", "4"]
    got = pools(2).run("cli", argv=argv, workdir=str(tmp_path / "grid"),
                       max_doublings=2)
    one = pools(1).run("cli", argv=argv, workdir=str(tmp_path / "one"),
                       max_doublings=2)[0]
    assert [g["rc"] for g in got] == [0, 0] and got[1]["files"] == []
    assert got[0]["files"] == one["files"]
    for f in one["files"]:
        assert ((tmp_path / "grid" / "rank0" / f).read_bytes()
                == (tmp_path / "one" / "rank0" / f).read_bytes()), f
    pooled = pools(1).run("cli", argv=[a.replace("n.dat", "p.dat")
                                       for a in argv] + ["--nuts-pooled"],
                          workdir=str(tmp_path / "pooled"), max_doublings=2)
    assert pooled[0]["rc"] == 0
    assert os.path.join("LFMCMCOut", "fitposterior_p_nb50_nw8_ns6_mcf50.dat"
                        ) in pooled[0]["files"]


def test_jax_reference_is_on_eight_devices():
    assert len(jax.devices()) >= 4
