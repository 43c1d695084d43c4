"""PyTorch port vs JAX package: the device grid (``parallel/``) on gloo
ranks on the CPU, float64.

The ranks (``tests/torch_grid_worker.py``: pools of 2 and of 4, started
once for the module) import no JAX; this process runs the JAX side on
its 8 virtual CPU devices and the meshless port, on the same inputs.
Cases are named after their JAX twins in ``tests/test_sharding.py``:

- ``make_lnprob_sharded`` on the (2,1), (1,2), (2,2) and (4,1) grids
  against the meshless port (rtol 1e-12) and JAX's
  ``make_lnprob_sharded`` on a mesh of the same shape (1e-9), for
  ``single`` (free and fixed completeness), ``z`` and ``hier``, an odd
  walker count, and exact bounds (``:36,48,57,318``);
- the kernel route (value kernels' plain versions, walkers over every
  rank) against the meshless kernel lnprob (1e-12), and the streaming
  route on source shards against the meshless streaming lnprob (the sum
  of the shards, 1e-10);
- a stretch run and a mix-move run on the grid against ``run_stretch``
  on the same generator, bit for bit (``:74``), one gathered lnprob
  call a half-step;
- ``run_stretch_ensembles_sharded``, ``run_tempered_sharded`` and
  ``run_parallel_tempering_sharded`` against their meshless twins bit
  for bit, the ensembles against JAX's steps on the same randoms and
  the swaps against JAX's ``_deo_swap`` (``:457,490,529``);
- a checkpointed ``fit_model`` on (2,1), rank 0 its only writer,
  resumed on (2,1) and on one rank; a rank that cannot see the
  checkpoint makes every rank raise;
- the CLI: ``fit --mesh-walkers 2`` on 2 ranks writes the one-process
  run's artifacts (rank 0 alone), ``fitz``/``fith``/``fit -fc`` with
  the long-run and evidence flags run on the grid.

NUTS on the grid is in ``tests/test_torch_grid_nuts.py``.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.parallel.mesh import make_mesh as jax_mesh
from lumfuncmcmc_tpu.parallel.sharding import (
    make_lnprob_sharded as jax_sharded)
from lumfuncmcmc_tpu.samplers import affine as jaff
from lumfuncmcmc_tpu.samplers import tempering as jt
from lumfuncmcmc_tpu_torch import LFConfig as PortConfig
from lumfuncmcmc_tpu_torch.cli.main import main as port_main
from lumfuncmcmc_tpu_torch.models.hierarchical import make_lnprob_h
from lumfuncmcmc_tpu_torch.models.likelihood import make_lnprob
from lumfuncmcmc_tpu_torch.models.likelihood_z import make_lnprob_z
from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.utils import synth
from tests.torch_grid_worker import RankPool
from tests.torch_mc_cases import _arrays, case, central


@pytest.fixture(scope="module")
def pools():
    made = {}

    def pool(world):
        if world not in made:
            made[world] = RankPool(world)
        return made[world]

    yield pool
    for p in made.values():
        p.close()


@contextlib.contextmanager
def _one_thread():
    """The ranks' threading: a run here compared bit for bit with theirs
    reduces in their order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _family(fam):
    c = case(fam)
    kw = dict(min_comp_frac=0.5, size_ln=21, fix_comp=fam != "free")
    return c, _arrays(c.jctx), kw


def _model_name(fam):
    return {"free": "single", "fixed": "single"}.get(fam, fam)


def _thetas(c, w=23, seed=4):
    return central(c.play, w, seed)


def test_smoke_check_facts(pools):
    for world in (2, 4):
        facts = pools(world).run("smoke")
        for r, f in enumerate(facts):
            assert f == {"process_index": r, "process_count": world,
                         "device_count": world, "local_device_count": 1,
                         "gathered_pids": list(range(world)),
                         "psum_total": float(world)}


LNPROB_CASES = [("free", (2, 1)), ("free", (1, 2)), ("free", (2, 2)),
                ("free", (4, 1)), ("fixed", (1, 2)), ("z", (2, 2)),
                ("z", (1, 2)), ("hier", (2, 2)), ("hier", (1, 2))]


@pytest.mark.parametrize("fam, shape", LNPROB_CASES)
def test_make_lnprob_sharded_matches_meshless_and_jax(pools, fam, shape):
    c, arrays, kw = _family(fam)
    model = _model_name(fam)
    th = _thetas(c)
    th[-1, 0] = c.play.hi[0] + 1.0                 # out of the box: -inf
    got = pools(shape[0] * shape[1]).run(
        "lnprob", arrays=arrays, cfg_kw=kw, model=model, shape=shape,
        thetas=th)
    for g in got[1:]:
        np.testing.assert_array_equal(g["lnp"], got[0]["lnp"])
    lnp = got[0]["lnp"]
    make = {"single": make_lnprob, "z": make_lnprob_z,
            "hier": make_lnprob_h}[model]
    want = make(c.pctx, c.play)(torch.as_tensor(th)).numpy()
    assert np.isneginf(lnp[-1]) and np.isneginf(want[-1])
    np.testing.assert_allclose(lnp[:-1], want[:-1], rtol=1e-12)
    jfn = jax.jit(jax_sharded(c.jctx, c.jlay, jax_mesh(*shape),
                              model=model))
    np.testing.assert_allclose(lnp[:-1],
                               np.asarray(jfn(jnp.asarray(th)))[:-1],
                               rtol=1e-9)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_exact_bounds_sharded_matches_meshless_and_jax(pools, shape):
    c, arrays, kw = _family("free")
    th = _thetas(c, w=9, seed=6)
    got = pools(shape[0] * shape[1]).run(
        "lnprob", arrays=arrays, cfg_kw=kw, model="single", shape=shape,
        thetas=th, exact_bounds=True)
    lnp = got[0]["lnp"]
    want = make_lnprob(c.pctx, c.play, exact_bounds=True)(
        torch.as_tensor(th)).numpy()
    np.testing.assert_allclose(lnp, want, rtol=1e-12)
    jfn = jax.jit(jax_sharded(c.jctx, c.jlay, jax_mesh(*shape),
                              model="single", exact_bounds=True))
    np.testing.assert_allclose(lnp, np.asarray(jfn(jnp.asarray(th))),
                               rtol=1e-9)


@pytest.mark.parametrize("fam, shape", [("free", (2, 1)), ("free", (2, 2)),
                                        ("fixed", (1, 2)), ("z", (2, 2)),
                                        ("hier", (4, 1))])
def test_kernel_route_matches_meshless_kernels(pools, fam, shape):
    c, arrays, kw = _family(fam)
    model = _model_name(fam)
    th = _thetas(c, w=21)
    got = pools(shape[0] * shape[1]).run(
        "lnprob", arrays=arrays, cfg_kw=kw, model=model, shape=shape,
        thetas=th, route="cuda")
    assert got[0]["engine"] == "plain"
    make = {"single": cl.make_cuda_lnprob, "z": cl.make_cuda_lnprob_z,
            "hier": cl.make_cuda_lnprob_h}[model]
    want = make(c.pctx, c.play)(torch.as_tensor(th)).numpy()
    for g in got:
        np.testing.assert_allclose(g["lnp"], want, rtol=1e-12)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_stream_route_on_source_shards_matches_unsharded(pools, shape,
                                                         monkeypatch):
    c, arrays, kw = _family("free")
    th = _thetas(c, w=15)
    th[0, 0] = c.play.lo[0] - 0.5                      # out of the box
    got = pools(shape[0] * shape[1]).run(
        "lnprob", arrays=arrays, cfg_kw=kw, model="single", shape=shape,
        thetas=th, route="stream")
    assert got[0]["engine"] == "plain-stream"
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES", 0)
    one = cl.make_cuda_lnprob(c.pctx, c.play)
    assert one.engine == "plain-stream"
    want = one(torch.as_tensor(th)).numpy()
    for g in got:
        assert np.isneginf(g["lnp"][0])
        np.testing.assert_allclose(g["lnp"][1:], want[1:], rtol=1e-10)


def test_stream_route_refuses_fixed_completeness():
    from lumfuncmcmc_tpu_torch.parallel.mesh import make_mesh
    from lumfuncmcmc_tpu_torch.parallel.sharding import (
        make_cuda_lnprob_stream_sharded)
    c = case("fixed")
    assert make_cuda_lnprob_stream_sharded(c.pctx, c.play,
                                           make_mesh(1, 1)) is None


@pytest.mark.parametrize("shape, move, route", [
    ((2, 1), "stretch", "eager"), ((4, 1), "mix", "eager"),
    ((2, 2), "stretch", "cuda")])
def test_stretch_on_the_grid_is_the_meshless_chain(pools, shape, move,
                                                   route):
    c, arrays, kw = _family("free")
    nw, nsteps = 14, 12
    got = pools(shape[0] * shape[1]).run(
        "stretch", arrays=arrays, cfg_kw=kw, shape=shape, move=move,
        nsteps=nsteps, nwalkers=nw, route=route)
    for g in got:
        for a, b in zip(g["grid"], g["meshless"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(g["grid"], got[0]["grid"]):
            np.testing.assert_array_equal(a, b)
        # one gathered call a half-step, of the whole half ensemble
        assert g["rows"] == [nw] + [nw // 2] * (2 * nsteps)
    assert 0 < got[0]["grid"][2].sum() < nw * nsteps


def _gauss_jax(x):
    prec = np.array([[2.0, 0.6, 0.0], [0.6, 1.0, 0.3], [0.0, 0.3, 0.5]])
    return -0.5 * jnp.einsum("wi,ij,wj->w", x, prec, x)


@pytest.mark.parametrize("world, move", [(2, "stretch"), (4, "mix")])
def test_ensembles_sharded_match_meshless_and_jax(pools, world, move):
    E, NW, NS = 4, 8, 8
    rng = np.random.default_rng(3)
    pos0 = rng.normal(size=(E, NW, 3))
    got = pools(world).run("ensembles", pos0=pos0, move=move, nsteps=NS)
    for g in got:
        for a, b in zip(g["grid"], g["meshless"]):
            np.testing.assert_array_equal(a, b)
        # each rank: one call a half-step over its ensembles' rows
        assert g["rows"] == ([E // world * NW]
                             + [E // world * NW // 2] * (2 * NS))
    # the pre-drawn form on numpy randoms against JAX's steps
    nh, shape = NW // 2, (NS, 2, E, NW // 2)
    sr = (rng.uniform(size=shape), rng.integers(0, nh, shape),
          np.log(rng.uniform(size=shape)))
    res = pools(world).run("ensembles", pos0=pos0, move="stretch",
                           nsteps=NS, rands=sr)[world - 1]
    for e in range(E):
        state = jaff.EnsembleState(jnp.asarray(pos0[e]),
                                   _gauss_jax(jnp.asarray(pos0[e])))
        for s in range(NS):
            state, _ = jaff._step_pre(
                tuple(jnp.asarray(x[s][:, e]) for x in sr), state,
                _gauss_jax, 2.0)
            np.testing.assert_allclose(res["chain"][e, s],
                                       np.asarray(state.pos), rtol=1e-10,
                                       atol=1e-12)
        np.testing.assert_allclose(res["lnp"][e, -1], np.asarray(state.lnp),
                                   rtol=1e-10)


@pytest.mark.parametrize("world, K, swap, move", [
    (2, 4, 0, "stretch"), (4, 8, 0, "de"), (2, 6, 3, "stretch"),
    (4, 8, 2, "mix")])
def test_ladders_sharded_match_meshless_and_jax_swaps(pools, world, K, swap,
                                                      move):
    W, D, NS = 8, 3, 12
    rng = np.random.default_rng(K + swap)
    pos0 = rng.uniform(-5.0, 5.0, size=(K, W, D))
    betas = jt.beta_ladder(K, 2.0)
    got = pools(world).run("ladder", pos0=pos0, betas=betas, nsteps=NS,
                           move=move, swap_every=swap)
    for g in got:
        assert len(g["grid"]) == len(g["meshless"])
        for a, b in zip(g["grid"], g["meshless"]):
            np.testing.assert_array_equal(a, b)
    if not swap:
        return
    g = got[0]
    chains, lnls = g["grid"][0], g["grid"][1]
    assert g["swaps"].any()
    for r in range(NS // swap):
        end = (r + 1) * swap - 1
        _, _, do = jt._deo_swap(jnp.asarray(chains[:, end]),
                                jnp.asarray(lnls[:, end]), jnp.asarray(betas),
                                jnp.asarray(g["u"][r]), r % 2)
        np.testing.assert_array_equal(g["swaps"][r], np.asarray(do))


@pytest.fixture(scope="module")
def catalog():
    kw = dict(min_comp_frac=0.5, size_ln=11, nwalkers=12, nsteps=40)
    cfg = PortConfig(**kw)
    cat = synth.apply_completeness_cut(
        synth.make_catalog(cfg, n_target=250, seed=11), cfg)
    return {k: cat[k] for k in ("z", "flux", "flux_e", "field_id")}, kw


def _one_rank_model(catalog, **over):
    cat, kw = catalog
    return LumFuncModel(PortConfig(**{**kw, **over}), z=cat["z"],
                        flux=cat["flux"], flux_e=cat["flux_e"],
                        field_id=cat["field_id"], device="cpu",
                        dtype=torch.float64)


def test_grid_checkpoint_resumes_on_the_grid_and_on_one_rank(pools, catalog,
                                                             tmp_path):
    pool = pools(2)
    path = str(tmp_path / "ck.npz")
    full = pool.run("fit_checkpoint", arrays_cfg=catalog, shape=(2, 1),
                    path=path, resume=False)
    assert [f["saves"] for f in full] == [4, 0]      # rank 0 alone writes
    for f in full[1:]:
        np.testing.assert_array_equal(f["chain"], full[0]["chain"])
    with np.load(path) as ck:
        np.testing.assert_array_equal(ck["chain"], full[0]["chain"])
        saved = {k: ck[k] for k in ck.files}
    # the meshless checkpointed run is the grid's
    with _one_thread():
        m = _one_rank_model(catalog, checkpoint_every=10)
        m.fit_model(checkpoint_path=str(tmp_path / "one.npz"))
    np.testing.assert_array_equal(m.chain, full[0]["chain"])
    # the grid resumes its npz cut at 2 blocks
    again = pool.run("fit_checkpoint", arrays_cfg=catalog, shape=(2, 1),
                     path=path, resume=True, cut=2)
    assert [f["saves"] for f in again] == [2, 0]
    for f in again:
        np.testing.assert_array_equal(f["chain"], full[0]["chain"])
        assert f["acc"] == full[0]["acc"]
    # one rank resumes the grid's npz cut at 1 block
    one = str(tmp_path / "cut.npz")
    np.savez(one, chain=saved["chain"][:10],
             lnprobability=saved["lnprobability"][:10],
             acc_blocks=saved["acc_blocks"][:1],
             fingerprint=saved["fingerprint"])
    with _one_thread():
        m = _one_rank_model(catalog, checkpoint_every=10)
        m.fit_model(checkpoint_path=one, resume=True)
    np.testing.assert_array_equal(m.chain, full[0]["chain"])
    # a rank that does not see the file: every rank raises
    msgs = pool.run("resume_mismatch", arrays_cfg=catalog, shape=(2, 1),
                    path=path)
    assert all("ranks disagree" in m for m in msgs), msgs


def test_model_ladder_and_ensembles_on_the_grid(pools, catalog):
    pool = pools(4)
    ev = pool.run("model", arrays_cfg=catalog, shape=(4, 1),
                  what="evidence", nrungs=6, nsteps=16, swap_every=4)
    assert ev[0]["nrungs"] == 8                  # 6 rounded up to 4 ranks
    with _one_thread():
        want = _one_rank_model(catalog).log_evidence(nrungs=8, nsteps=16,
                                                     swap_every=4)
    for e in ev:
        assert e["lnz_ss"] == want["lnz_ss"] and e["lnz_ti"] == want["lnz_ti"]
        np.testing.assert_array_equal(e["swap_frac"], want["swap_frac"])
    ens = pool.run("model", arrays_cfg=catalog, shape=(2, 2),
                   what="ensembles", nensembles=3)
    with _one_thread():
        m = _one_rank_model(catalog)
        m.fit_model_ensembles(4)
    for e in ens:
        np.testing.assert_array_equal(e["samples"], m.samples)
        np.testing.assert_array_equal(e["rhat"], m.rhat_ensembles)


FIT = ["--synthetic", "250", "-mcf", "0.5", "-ns", "30", "-nw", "12",
       "--size-ln", "11", "--device", "cpu"]


def _config(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text('{"output_dict": {"parameters": true, "settings": '
                    'false, "fitposterior": true, "bestfitLF": true, '
                    '"VeffLF": true, "triangle plot": false, "image '
                    'format": "png"}}')
    return ["--config", str(path)]


def test_cli_fit_on_two_ranks_writes_the_one_process_artifacts(
        pools, tmp_path, monkeypatch):
    argv = ["fit"] + FIT + ["-o", "g.dat", "--mesh-walkers", "2"] \
        + _config(tmp_path)
    got = pools(2).run("cli", argv=argv, workdir=str(tmp_path / "grid"))
    base = "g_nb50_nw12_ns30_mcf50"
    assert got[0]["rc"] == 0 and got[1]["rc"] == 0
    assert got[1]["files"] == []                    # rank 0 alone writes
    assert set(got[0]["files"]) == {
        os.path.join("LFMCMCOut", f) for f in (
            f"fitposterior_{base}.dat", f"bestfitLF_{base}.dat",
            f"VeffLF_{base}.dat", "g.dat")}
    one = tmp_path / "one"
    one.mkdir()
    monkeypatch.chdir(one)
    with _one_thread():
        assert port_main(argv[:-4] + argv[-2:]) == 0
    for f in got[0]["files"]:
        assert (one / f).read_bytes() == (tmp_path / "grid" / "rank0" / f
                                          ).read_bytes(), f


def test_cli_long_runs_and_evidence_on_the_grid(pools, tmp_path):
    cfg = _config(tmp_path)
    runs = {
        "a": ["fitz", "--mesh-sources", "2", "--min-ess", "50",
              "--checkpoint-every", "10"],
        "b": ["fith", "--ensembles", "2", "--evidence", "3",
              "--evidence-swap", "3"],
        "c": ["fit", "-fc", "--mesh-walkers", "0", "--evidence", "4",
              "--checkpoint-every", "10"],
        "d": ["fit", "--mesh-sources", "2", "--exact-bounds", "-ns", "4"],
    }
    out = {"fitz": "LFMCMCzOut", "fith": "LFMCMCHOut", "fit": "LFMCMCOut"}
    for name, flags in runs.items():
        nw = "32" if flags[0] == "fith" else "12"
        argv = ([flags[0]] + FIT + flags[1:] + ["-o", f"{name}.dat", "-nw",
                                                 nw] + cfg)
        got = pools(2).run("cli", argv=argv,
                           workdir=str(tmp_path / name))
        assert [g["rc"] for g in got] == [0, 0], (name, got)
        assert got[1]["files"] == []
        ns = "4" if "-ns" in flags else "30"
        post = os.path.join(
            out[flags[0]], f"fitposterior_{name}_nb50_nw{nw}_ns{ns}_mcf50.dat")
        assert post in got[0]["files"], (name, got[0]["files"])
        if "--evidence" in flags:
            assert post.replace("fitposterior", "evidence") in got[0]["files"]


def test_jax_sharded_reference_is_on_eight_devices():
    assert len(jax.devices()) >= 4
