"""PyTorch port: the stretch long-run drivers and the ensemble diagnostics.

- ``gelman_rubin_ensembles`` / ``rank_normalized_rhat_ensembles`` against
  the JAX package's at rtol 1e-12;
- ``run_ensembles_with_rands`` on pre-drawn numpy randoms: ensemble e
  equals JAX's ``_step_pre`` / ``_step_de_pre`` chain on ``rands[:, :,
  e]`` at 1e-10, with one lnprob call a half-step over all E x W/2 rows;
- the checkpoint protocol (the port's own): a run resumed from its npz
  cut at any block boundary is ``np.array_equal`` to the uninterrupted
  checkpointed run (chain, lnprobability, acceptance, min-ess stopping
  decisions) for ``fit_model`` (stretch, and mix with thin),
  ``fit_model_until`` and ``fit_model_ensembles`` (with and without
  ``min_ess``); ``nsteps`` is not fingerprinted, so a finished run
  extends; a changed knob, a JAX-written npz and a CPU npz read by a CUDA
  model are refused, naming the fields;
- the CLI: ``fitz --min-ess`` and ``fith --ensembles 2`` write the JAX
  CLI's artifacts.
"""

import functools
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.samplers import affine as jaff
from lumfuncmcmc_tpu_torch import LFConfig
from lumfuncmcmc_tpu_torch.cli.main import main as port_main
from lumfuncmcmc_tpu_torch.models import ensemble_driver as ed
from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
from lumfuncmcmc_tpu_torch.samplers import affine as taff
from lumfuncmcmc_tpu_torch.samplers import diagnostics as tdiag
from lumfuncmcmc_tpu_torch.utils.synth import (
    apply_completeness_cut, make_catalog)

jdiag = importlib.import_module("lumfuncmcmc_tpu.samplers.diagnostics")

torch.set_num_threads(2)
NW, NDIM, E, NSTEPS = 12, 3, 3, 10
PREC = np.array([[2.0, 0.6, 0.0], [0.6, 1.0, 0.3], [0.0, 0.3, 0.5]])


def _lnp_jax(x):
    return -0.5 * jnp.einsum("wi,ij,wj->w", x, PREC, x)


def _lnp_torch(x):
    return -0.5 * torch.einsum("wi,ij,wj->w", x, torch.as_tensor(PREC), x)


def test_ensemble_rhat_diagnostics_match_jax():
    rng = np.random.default_rng(8)
    x = np.cumsum(rng.normal(size=(3, 120, 8, 2)), axis=1) * 0.1 \
        + rng.normal(size=(3, 120, 8, 2))
    x[:, 60:, :, 0] = x[:, 60:, :, 0].round(1)    # ties for the ranks
    for name in ("gelman_rubin_ensembles",
                 "rank_normalized_rhat_ensembles"):
        np.testing.assert_allclose(getattr(tdiag, name)(x),
                                   getattr(jdiag, name)(x), rtol=1e-12,
                                   err_msg=name)
    with pytest.raises(ValueError, match="C>=2"):
        tdiag.gelman_rubin_ensembles(x[:1])


def _rands(rng, move):
    nh, shape = NW // 2, (NSTEPS, 2, E, NW // 2)
    sr = (rng.uniform(size=shape), rng.integers(0, nh, shape),
          np.log(rng.uniform(size=shape)))
    g = 2.38 / np.sqrt(2 * NDIM) * (1 + 1e-5 * rng.normal(size=shape))
    g = np.where(rng.uniform(size=shape) < 0.1, 1.0, g)
    j1 = rng.integers(0, nh, shape)
    j2 = rng.integers(0, nh - 1, shape)
    dr = (g, j1, j2 + (j2 >= j1), np.log(rng.uniform(size=shape)))
    return sr, dr


@pytest.mark.parametrize("move", ["stretch", "de", "mix"])
def test_ensembles_match_jax_steps_one_call_a_half_step(move):
    rng = np.random.default_rng(3)
    pos0 = rng.normal(size=(E, NW, NDIM))
    sr, dr = _rands(rng, move)
    sel = jaff.de_schedule(NSTEPS, 0.4)
    calls = []

    def counted(th):
        calls.append(th.shape[0])
        return _lnp_torch(th)

    t = lambda rs: tuple(torch.as_tensor(x) for x in rs)  # noqa: E731
    rands = {"stretch": t(sr), "de": t(dr), "mix": (sel, t(sr), t(dr))}
    st, chain, lnps, acc = taff.run_ensembles_with_rands(
        counted, torch.as_tensor(pos0), rands[move], NSTEPS, move=move)
    assert calls == [E * NW] + [E * NW // 2] * (2 * NSTEPS)
    assert chain.shape == (E, NSTEPS, NW, NDIM) and acc.shape == (E, NW)
    for e in range(E):
        state = jaff.EnsembleState(jnp.asarray(pos0[e]),
                                   _lnp_jax(jnp.asarray(pos0[e])))
        want, want_acc = [], 0.0
        for s in range(NSTEPS):
            if move == "stretch" or (move == "mix" and not sel[s]):
                r = tuple(jnp.asarray(x[s][:, e]) for x in sr)
                state, a = jaff._step_pre(r, state, _lnp_jax, 2.0)
            else:
                r = tuple(jnp.asarray(x[s][:, e]) for x in dr)
                state, a = jaff._step_de_pre(r, state, _lnp_jax)
            want.append(np.asarray(state.pos))
            want_acc = want_acc + np.asarray(a)
        np.testing.assert_allclose(chain[e].numpy(), np.stack(want),
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_array_equal(acc[e].numpy(), want_acc)
        np.testing.assert_allclose(lnps[e, -1].numpy(),
                                   np.asarray(state.lnp), rtol=1e-10)
    assert 0 < float(acc.sum()) < E * NW * NSTEPS
    # the generator form: one call a half-step too, ensembles distinct
    calls.clear()
    gen = torch.Generator().manual_seed(2)
    _, ch, _, _ = taff.run_stretch_ensembles(
        counted, torch.as_tensor(pos0), gen, 4, move=move, thin=2)
    assert calls == [E * NW] + [E * NW // 2] * 8 and ch.shape[:2] == (E, 2)


@functools.lru_cache(maxsize=None)
def _catalog():
    cfg = LFConfig(min_comp_frac=0.5)
    return apply_completeness_cut(make_catalog(cfg, n_target=150, seed=5),
                                  cfg)


def _model(**kw):
    cat = _catalog()
    cfg = LFConfig(min_comp_frac=0.5, size_ln=7, nwalkers=16,
                   nsteps=24).replace(**kw)
    return LumFuncModel(cfg, z=cat["z"], flux=cat["flux"],
                        flux_e=cat["flux_e"], field_id=cat["field_id"],
                        device="cpu", dtype=torch.float64)


def _cut(src, dst, nblocks, axis=0):
    """The checkpoint block ``nblocks`` wrote, cut from ``src``'s."""
    with np.load(src) as ck:
        d = {k: ck[k] for k in ck.files}
    rows = d["chain"].shape[axis] * nblocks // len(d["acc_blocks"])
    for k in ("chain", "lnprobability"):
        d[k] = np.take(d[k], np.arange(rows), axis=axis)
    d["acc_blocks"] = d["acc_blocks"][:nblocks]
    np.savez(dst, **d)


def _same_run(a, b):
    np.testing.assert_array_equal(a.chain, b.chain)
    np.testing.assert_array_equal(a.samples, b.samples)
    assert a.acceptance_fraction == b.acceptance_fraction


@pytest.mark.parametrize("kw", [dict(), dict(move="mix", de_prob=0.3,
                                             thin=2)])
def test_fit_model_resumes_exactly_from_every_block(tmp_path, kw):
    ck = str(tmp_path / "ck.npz")
    full = _model(checkpoint_every=8, **kw)
    full.fit_model(checkpoint_path=ck)
    with np.load(ck) as f:
        assert len(f["acc_blocks"]) == 3
        assert f["chain"].shape[0] == 24 // kw.get("thin", 1)
    for k in (1, 2):
        part = str(tmp_path / f"ck{k}.npz")
        _cut(ck, part, k)
        again = _model(checkpoint_every=8, **kw)
        again.fit_model(checkpoint_path=part, resume=True)
        _same_run(again, full)
    # nsteps is not fingerprinted: the 24-step checkpoint extends to 40
    # steps exactly as the uninterrupted 40-step checkpointed run
    longer = _model(checkpoint_every=8, nsteps=40, **kw)
    longer.fit_model(checkpoint_path=ck, resume=True)
    ref = _model(checkpoint_every=8, nsteps=40, **kw)
    ref.fit_model(checkpoint_path=str(tmp_path / "ref.npz"))
    _same_run(longer, ref)


def test_fit_model_until_resumes_its_decisions_and_stops(tmp_path):
    ck = str(tmp_path / "until.npz")
    full = _model(move="mix")
    full.fit_model_until(1e9, block_steps=10, max_blocks=3,
                         checkpoint_path=ck)
    assert full.chain.shape[0] == 30
    for k in (1, 2):
        part = str(tmp_path / f"until{k}.npz")
        _cut(ck, part, k)
        again = _model(move="mix")
        again.fit_model_until(1e9, block_steps=10, max_blocks=3,
                              checkpoint_path=part, resume=True)
        _same_run(again, full)
    # block b draws as the checkpointed run's block b: the same chain
    blocked = _model(move="mix", nsteps=30, checkpoint_every=10)
    blocked.fit_model()
    np.testing.assert_array_equal(blocked.chain, full.chain)
    # a target the first block meets, and min_ess = 0: one block each
    one = _model()
    one.fit_model_until(0.0, block_steps=10)
    assert one.chain.shape[0] == 10 and one.samples.shape[1] == 10
    with pytest.raises(ValueError, match="block_steps: saved 10, current 12"):
        _model(move="mix").fit_model_until(1e9, block_steps=12,
                                           checkpoint_path=ck, resume=True)


@pytest.mark.parametrize("min_ess", [None, 1e9])
def test_fit_model_ensembles_resumes_exactly(tmp_path, min_ess):
    ck = str(tmp_path / "ens.npz")
    kw = (dict(checkpoint_every=8) if min_ess is None
          else dict(nsteps=8))
    full = _model(**kw)
    full.fit_model_ensembles(2, checkpoint_path=ck, min_ess=min_ess,
                             max_blocks=3)
    assert full.chain.shape[:2] == (24, 32)
    assert full.rhat_ensembles.shape == (full.layout.ndim,)
    part = str(tmp_path / "ens1.npz")
    _cut(ck, part, 2, axis=1)
    again = _model(**kw)
    again.fit_model_ensembles(2, checkpoint_path=part, resume=True,
                              min_ess=min_ess, max_blocks=3)
    _same_run(again, full)
    with pytest.raises(ValueError, match="nensembles: saved 2, current 3"):
        _model(**kw).fit_model_ensembles(3, checkpoint_path=ck,
                                         resume=True, min_ess=min_ess)


def test_checkpoint_refusals_name_the_fields(tmp_path, monkeypatch):
    ck = str(tmp_path / "ck.npz")
    _model(checkpoint_every=8).fit_model(checkpoint_path=ck)
    for kw, field in ((dict(seed=7), "seed: saved 42, current 7"),
                      (dict(nwalkers=20), "nwalkers: saved 16, current 20"),
                      (dict(move="de"), "move: saved 0, current 1")):
        with pytest.raises(ValueError, match=field):
            _model(checkpoint_every=8, **kw).fit_model(
                checkpoint_path=ck, resume=True)
    # an npz of another writer (here the JAX package's layout) is refused
    jax_like = str(tmp_path / "jax.npz")
    np.savez(jax_like, chain=np.zeros((8, 16, 9)),
             lnprobability=np.zeros((8, 16)), acc=np.zeros(16),
             fingerprint=np.asarray([16, 1, 8, 42, 0, 5000]))
    with pytest.raises(ValueError, match="not written by this port"):
        _model(checkpoint_every=8).fit_model(checkpoint_path=jax_like,
                                             resume=True)
    # a CPU-written npz read by a CUDA model (its generators and device
    # sync faked on the CPU): the device field differs
    model = _model(checkpoint_every=8)
    model.device = torch.device("cuda")
    monkeypatch.setattr(ed, "stream_generator",
                        lambda *a: torch.Generator().manual_seed(0))
    monkeypatch.setattr(ed, "_sync", lambda device: None)
    with pytest.raises(ValueError, match="device: saved 0, current 1"):
        model.fit_model(generator=torch.Generator(), checkpoint_path=ck,
                        resume=True)


def _cfg_file(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text('{"output_dict": {"parameters": true, "settings": '
                    'true, "fitposterior": true, "bestfitLF": true, '
                    '"VeffLF": true, "triangle plot": false, '
                    '"image format": "png"}}')
    return ["--config", str(path)]


@pytest.mark.parametrize("command, outdir, extra", [
    ("fitz", "LFMCMCzOut", ["--min-ess", "1e9", "-ns", "10"]),
    ("fith", "LFMCMCHOut", ["--ensembles", "2", "-ns", "12",
                            "--checkpoint-every", "6"])])
def test_cli_long_runs_of_fitz_and_fith(tmp_path, monkeypatch, command,
                                        outdir, extra):
    monkeypatch.chdir(tmp_path)
    base = ["--synthetic", "150", "-mcf", "0.5", "-nw", "16", "--size-ln",
            "7", "-o", "l.dat", "--device", "cpu"] + _cfg_file(tmp_path)
    if command == "fitz":
        monkeypatch.setattr(ed._EnsembleDriverMixin, "fit_model_until",
                            functools.partialmethod(
                                ed._EnsembleDriverMixin.fit_model_until,
                                max_blocks=2))
    assert port_main([command] + base + extra) == 0
    ns = extra[extra.index("-ns") + 1]
    stem = f"l_nb50_nw16_ns{ns}_mcf50"
    files = sorted(os.listdir(tmp_path / outdir))
    want = [f"{k}_{stem}.dat" for k in ("VeffLF", "bestfitLF",
                                         "fitposterior")]
    want += ["l.dat", "l.dat.args"]
    if command == "fith":
        want.append(f"checkpoint_ens_{stem}.npz")
    assert files == sorted(want)


def test_a_jax_written_checkpoint_is_refused(tmp_path, monkeypatch):
    """The JAX CLI's own checkpointed fit writes
    ``LFMCMCOut/checkpoint_*.npz``; with its posterior removed, the
    port's CLI on the same command finds that npz and refuses it."""
    from lumfuncmcmc_tpu.cli.main import main as jax_main
    monkeypatch.chdir(tmp_path)
    argv = ["fit", "--synthetic", "120", "-mcf", "0.5", "-nw", "8", "-ns",
            "6", "--size-ln", "7", "--checkpoint-every", "3", "-o",
            "j.dat"] + _cfg_file(tmp_path)
    assert jax_main(argv) == 0
    out = tmp_path / "LFMCMCOut"
    ck = out / "checkpoint_j_nb50_nw8_ns6_mcf50.npz"
    assert ck.exists()
    (out / "fitposterior_j_nb50_nw8_ns6_mcf50.dat").unlink()
    with pytest.raises(ValueError, match="not written by this port's "
                                         "checkpoint protocol"):
        port_main(argv + ["--device", "cpu"])
