"""PyTorch port: NUTS continuation, min-ess blocks and checkpoints.

- ``continue_nuts_with`` fed the numbers JAX's ``continue_nuts_keys``
  draws from ``sampling_keys(key, m, n)`` continues JAX's own warmed-up
  state to JAX's chain at 1e-8 (a 2-D Gaussian, so JAX compiles in
  seconds); ``run_nuts(m)`` continued by ``continue_nuts(n - m)`` is
  ``run_nuts(n)`` bit for bit;
- ``fit_model_nuts``: the fixed-length checkpointed chain equals the
  plain run's, and a resume from its npz cut at a block boundary
  reproduces it; a min-ess run of B blocks is the plain run of B x
  nsteps samples, and its resume reproduces the chain and the stopping
  decisions; the streaming route (the gate lowered) takes the same
  blocks; a CPU-written npz read by a CUDA model is refused.
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.samplers import nuts as jnuts
from lumfuncmcmc_tpu_torch import LFConfig
from lumfuncmcmc_tpu_torch.models import nuts_driver as nd
from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.samplers import nuts as tnuts
from lumfuncmcmc_tpu_torch.utils.synth import (
    apply_completeness_cut, make_catalog)

torch.set_num_threads(2)
PREC = np.linalg.inv(np.array([[1.0, 0.9], [0.9, 1.0]]))


def _jax_lnp(y):
    return -0.5 * y @ jnp.asarray(PREC) @ y


def _torch_lnp(y):
    return -0.5 * torch.einsum("ci,ij,cj->c", y, torch.as_tensor(PREC), y)


@functools.partial(jax.jit, static_argnames=("ndim", "md"))
def _jax_draws(keys, ndim, md):
    """The numbers JAX's ``_nuts_step`` draws from each key (the same
    construction as ``tests/test_torch_nuts.py``)."""
    def one(key):
        k_mom, k_dir = jax.random.split(key)
        p0 = jax.random.normal(k_mom, (ndim,), dtype=jnp.float64)

        def doubling(key, _):
            key, k_d, k_swap, k_b = jax.random.split(key, 4)

            def leapfrog(ks, _):
                ks, k = jax.random.split(ks)
                return ks, jax.random.uniform(k, dtype=jnp.float64)

            _, u = jax.lax.scan(leapfrog, k_swap, None, length=2 ** (md - 1))
            return key, (jax.random.bernoulli(k_d), u,
                         jax.random.uniform(k_b, dtype=jnp.float64))

        _, (go, u, us) = jax.lax.scan(doubling, k_dir, None, length=md)
        return p0, go, u, us

    return jax.vmap(one)(keys)


def test_continue_nuts_matches_jax_continue_nuts_keys():
    nchains, m, n = 3, 6, 16
    key = jax.random.PRNGKey(7)
    y0 = np.random.default_rng(1).normal(size=(nchains, 2))
    first = jnuts.run_nuts(_jax_lnp, jnp.asarray(y0), key, num_warmup=40,
                           num_samples=m, return_state=True)
    state = first[5]
    ids = jnp.arange(nchains, dtype=jnp.uint32)
    want = jnuts.continue_nuts_keys(_jax_lnp, state,
                                    jnuts.sampling_keys(key, m, n, ids))
    keys = jnuts.sampling_keys(key, m, n, ids)
    p0, go, u, us = (torch.as_tensor(np.array(a)) for a in _jax_draws(
        keys.reshape((-1,) + keys.shape[2:]), 2, 8))

    def draw(phase, t):
        assert phase == "s" and m <= t < n
        sl = slice((t - m) * nchains, (t - m + 1) * nchains)
        return tnuts.NutsRands(p0[sl], go[sl], u[sl], us[sl])

    tstate = tuple(torch.as_tensor(np.array(x)) for x in state)
    got = tnuts.continue_nuts_with(draw, _torch_lnp, tstate, m, n)
    for name, g, w in (("samples", got.samples, want[0]),
                       ("lnp", got.lnps, want[1]),
                       ("accept_stat", got.alphas, want[2]),
                       ("div_frac", got.div_frac, want[3]),
                       ("y_run", got.y_run, want[4][0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8,
                                   atol=1e-10, err_msg=name)
    assert got.counts.transitions == n - m


def test_run_nuts_continued_is_the_longer_run():
    y0 = torch.as_tensor(np.random.default_rng(2).normal(size=(3, 2)))
    runs = {}
    for split in (None, 5):
        gen = torch.Generator().manual_seed(3)
        if split is None:
            runs[split] = tnuts.run_nuts(_torch_lnp, y0, gen, 40, 12).samples
        else:
            a = tnuts.run_nuts(_torch_lnp, y0, gen, 40, split)
            b = tnuts.continue_nuts(_torch_lnp, a.state, gen, 12 - split)
            runs[split] = torch.cat([a.samples, b.samples])
    assert torch.equal(runs[None], runs[5])


@functools.lru_cache(maxsize=None)
def _catalog():
    cfg = LFConfig(min_comp_frac=0.5)
    return apply_completeness_cut(make_catalog(cfg, n_target=150, seed=5),
                                  cfg)


def _model(**kw):
    cat = _catalog()
    cfg = LFConfig(min_comp_frac=0.5, size_ln=7, fix_comp=True,
                   nwalkers=16, nsteps=6).replace(**kw)
    return LumFuncModel(cfg, z=cat["z"], flux=cat["flux"],
                        flux_e=cat["flux_e"], field_id=cat["field_id"],
                        device="cpu", dtype=torch.float64)


RUN = dict(num_warmup=12, nchains=3)


def _cut(src, dst, nblocks):
    """The NUTS checkpoint block ``nblocks`` wrote, cut from ``src``'s."""
    with np.load(src) as ck:
        d = {k: ck[k] for k in ck.files}
    rows = int(d["sizes"][:nblocks].sum())
    for k in ("samples_y", "lnps_y", "alphas"):
        d[k] = d[k][:rows]
    for k in ("sizes", "df", "y_run", "generator"):
        d[k] = d[k][:nblocks]
    np.savez(dst, **d)


def test_fixed_length_checkpoints_give_the_plain_chain(tmp_path):
    plain = _model(nsteps=10)
    plain.fit_model_nuts(**RUN)
    ck = str(tmp_path / "nuts.npz")
    blocked = _model(nsteps=10, checkpoint_every=4)
    blocked.fit_model_nuts(checkpoint_path=ck, **RUN)
    np.testing.assert_array_equal(blocked.chain, plain.chain)
    np.testing.assert_array_equal(blocked.samples, plain.samples)
    with np.load(ck) as f:
        assert list(f["sizes"]) == [4, 4, 2]
    for k in (1, 2):
        part = str(tmp_path / f"nuts{k}.npz")
        _cut(ck, part, k)
        again = _model(nsteps=10, checkpoint_every=4)
        again.fit_model_nuts(checkpoint_path=part, resume=True, **RUN)
        np.testing.assert_array_equal(again.samples, plain.samples)
        assert again.nuts_counts.transitions == 10 - 4 * k
    with pytest.raises(ValueError, match="checkpoint_every: saved 4, "
                                         "current 5"):
        _model(nsteps=10, checkpoint_every=5).fit_model_nuts(
            checkpoint_path=ck, resume=True, **RUN)


def _min_ess_runs(tmp_path, **kw):
    """A 3-block min-ess run (target never met) against the plain run of
    18 samples, then its resumes from 1 and 2 blocks."""
    plain = _model(nsteps=18, **kw)
    plain.fit_model_nuts(**RUN)
    ck = str(tmp_path / "ess.npz")
    full = _model(**kw)
    full.fit_model_nuts(min_ess=1e9, max_blocks=3, checkpoint_path=ck,
                        **RUN)
    np.testing.assert_array_equal(full.samples, plain.samples)
    for k in (1, 2):
        part = str(tmp_path / f"ess{k}.npz")
        _cut(ck, part, k)
        again = _model(**kw)
        again.fit_model_nuts(min_ess=1e9, max_blocks=3,
                             checkpoint_path=part, resume=True, **RUN)
        np.testing.assert_array_equal(again.samples, full.samples)
    return full


def test_min_ess_blocks_resume_exactly_and_stop(tmp_path):
    _min_ess_runs(tmp_path)
    one = _model()
    one.fit_model_nuts(min_ess=1.0, **RUN)       # met after one block
    assert one.chain.shape[0] == 6


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.text = []

    def emit(self, record):
        self.text.append(record.getMessage())


def test_min_ess_blocks_on_the_streaming_route(tmp_path, monkeypatch):
    """Free completeness through the streaming kernels' plain versions
    (the gate lowered): two min-ess blocks, and the resume of the second
    from the first's checkpoint."""
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES", 0)
    lines = _Lines()
    log = logging.getLogger("lumfuncmcmc_tpu_torch")
    log.addHandler(lines)
    run = dict(num_warmup=12, nchains=2, min_ess=1e9, max_blocks=2)
    kw = dict(fix_comp=False, use_pallas=True, nsteps=2)
    try:
        ck = str(tmp_path / "stream.npz")
        full = _model(**kw)
        full.fit_model_nuts(checkpoint_path=ck, **run)
        part = str(tmp_path / "stream1.npz")
        _cut(ck, part, 1)
        again = _model(**kw)
        again.fit_model_nuts(checkpoint_path=part, resume=True, **run)
    finally:
        log.removeHandler(lines)
    np.testing.assert_array_equal(again.samples, full.samples)
    assert full.nuts_counts.transitions == 12 + 4
    assert again.nuts_counts.transitions == 2
    text = "\n".join(lines.text)
    assert "plain versions of the streaming kernels" in text
    assert "NUTS gradient path: plain value+gradient" in text
    assert text.count("NUTS block 2: 4 samples") == 2


def test_a_cpu_checkpoint_is_refused_on_the_card(tmp_path, monkeypatch):
    ck = str(tmp_path / "nuts.npz")
    _model().fit_model_nuts(min_ess=1e9, max_blocks=2, checkpoint_path=ck,
                            **RUN)
    model = _model()
    model.device = torch.device("cuda")
    monkeypatch.setattr(nd, "_sync", lambda device: None)
    with pytest.raises(ValueError, match="device: saved 0, current 1"):
        model.fit_model_nuts(generator=torch.Generator(), min_ess=1e9,
                             max_blocks=2, checkpoint_path=ck, resume=True,
                             **RUN)
