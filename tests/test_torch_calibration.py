"""PyTorch port vs JAX package: the calibration replicates
(``lumfuncmcmc_tpu_torch/utils/calibration.py``).

The scorers, the thinned rank draw and the hierarchical truth draw are
numpy in both packages and must agree exactly on one ``default_rng``.
Each replicate runs in JAX as it is (its ``run_stretch`` recorded), then
in the port on the CPU (float64, eager engine) with JAX's ``pos0`` and
JAX's randoms, drawn from the recorded key as
``lumfuncmcmc_tpu/samplers/affine.py:216-221`` draws them, fed through
the port's run seam (``_run``): the chain within 1e-8, ranks, cover and
catalog size equal, tau within 1e-8 relative. The ``-m slow`` gates are
``tests/test_calibration.py``'s, run on the port at their own K, seeds
and bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.samplers import affine as jaff
from lumfuncmcmc_tpu.utils import calibration as jcal
from lumfuncmcmc_tpu_torch.samplers import affine as taff
from lumfuncmcmc_tpu_torch.utils import calibration as tcal

torch.set_num_threads(2)


class _Stop(Exception):
    """Ends a replicate at its run step, carrying what reached it."""


def _jax_rands(key, nsteps, nh, ndim, move, dtype):
    """JAX ``run_stretch``'s draws from ``key``, as torch tensors in the
    port's ``run_with_rands`` layout."""
    def stretch(k):
        k_z, k_j, k_a = jax.random.split(k, 3)
        return (jax.random.uniform(k_z, (nsteps, 2, nh), dtype=dtype),
                jax.random.randint(k_j, (nsteps, 2, nh), 0, nh),
                jnp.log(jax.random.uniform(k_a, (nsteps, 2, nh),
                                           dtype=dtype)))

    def t(xs):
        return tuple(torch.as_tensor(np.array(x)) for x in xs)

    if move == "stretch":
        return t(stretch(key))
    assert move == "mix"
    k_s, k_d = jax.random.split(key)
    return (jaff.de_schedule(nsteps, 0.5), t(stretch(k_s)),
            t(jaff._de_rands(k_d, nsteps, nh, ndim, dtype)))


def _both(fn_name, seed, k, port_fn=None, jax_kw=(), **kw):
    """JAX's replicate ``fn_name`` (with ``jax_kw`` over ``kw``), its run
    recorded, then the port's (``port_fn``, default the same name) on
    ``device="cpu"`` fed JAX's pos0 and randoms. Returns (JAX result,
    JAX chain, port result, port chain)."""
    runs, got = [], []
    real = jcal.run_stretch

    def record(lnprob, pos0, key, nsteps, move="stretch"):
        out = real(lnprob, pos0, key, nsteps, move=move)
        runs.append((np.asarray(pos0), key, nsteps, move,
                     np.asarray(out[1])))
        return out

    def feed(lnprob, pos0, generator, nsteps, move="stretch"):
        jpos0, key, jn, jmove, _ = runs[0]
        assert (tuple(pos0.shape), nsteps, move) == (jpos0.shape, jn, jmove)
        assert pos0.dtype == torch.float64 and lnprob.engine == "eager"
        rands = _jax_rands(key, nsteps, jpos0.shape[0] // 2, jpos0.shape[1],
                           move, jpos0.dtype)
        _, chain, _, _ = taff.run_with_rands(
            lnprob, torch.as_tensor(np.array(jpos0)), rands, nsteps, move=move)
        got.append(chain.numpy())
        return got[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcal, "run_stretch", record)
        want = getattr(jcal, fn_name)(k, np.random.default_rng(seed),
                                      **{**kw, **dict(jax_kw)})
        mp.setattr(tcal, "_run", feed)
        out = (port_fn or getattr(tcal, fn_name))(
            k, np.random.default_rng(seed), device="cpu", **kw)
    assert len(runs) == 1 and len(got) == 1
    return want, runs[0][4], out, got[0]


def _same_chain(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
    # the chain moved: the comparison is not of two starting points
    assert np.abs(want[-1] - want[0]).max() > 1e-3


@pytest.fixture(scope="module")
def sbc_runs():
    return _both("sbc_replicate", 7, 1, nwalkers=16, nsteps=60, M=7,
                 size_ln=21)


@pytest.fixture(scope="module")
def hier_runs():
    return _both("sbc_replicate_h", 23, 1, nwalkers=20, nsteps=50,
                 size_ln=21)


def test_scorers_and_rank_draw_match_jax():
    rng = np.random.default_rng(5)
    names = ["a", "b", "c"]
    for _ in range(20):
        post = rng.normal(size=(300, 3))
        truth = dict(zip(names, rng.normal(scale=1.5, size=3)))
        assert (tcal._interval_coverage(post, names, truth)
                == jcal._interval_coverage(post, names, truth))
    # calibration.py:96-102 (and :252-257): the thinned rank draw
    for rows, tau, M in ((40, 3.2, 7), (40, 30.0, 7), (7, 0.2, 7),
                         (100, 11.9, 5)):
        post = rng.normal(size=(rows, 12, 4))
        tvec = rng.normal(size=4)
        seed = int(rng.integers(1 << 30))
        r_jax = np.random.default_rng(seed)
        gap = max(min(int(2 * tau), post.shape[0] // M), 1)
        steps = gap * np.arange(M)
        walkers = r_jax.choice(post.shape[1], size=M, replace=False)
        want = (post[steps, walkers] < tvec[None, :]).sum(axis=0)
        r_port = np.random.default_rng(seed)
        got = tcal._thinned_ranks(post, tau, M, r_port, tvec)
        np.testing.assert_array_equal(got, want)
        assert r_port.random() == r_jax.random()      # same draws consumed
    with pytest.raises(ValueError, match="distinct thinned draws"):
        tcal._thinned_ranks(rng.normal(size=(6, 12, 4)), 1.0, 7, rng, tvec)
    assert tcal.PARAMS == jcal.PARAMS
    assert tcal.SBC_BOX == jcal.SBC_BOX and tcal.HIER_BOX == jcal.HIER_BOX


@pytest.mark.parametrize("fix_sch_al", [False, True])
def test_hier_truth_draw_matches_jax(fix_sch_al):
    from lumfuncmcmc_tpu.config import LFConfig as JCfg
    from lumfuncmcmc_tpu.models.hierarchical import ThetaLayoutH as JLay
    from lumfuncmcmc_tpu_torch.config import LFConfig as TCfg
    from lumfuncmcmc_tpu_torch.models.hierarchical import ThetaLayoutH
    for nf in (2, 5):
        kw = dict(fix_comp=True, fix_sch_al=fix_sch_al, **jcal.HIER_BOX)
        jl = JLay.from_config(JCfg(**kw).replace(
            Flim=JCfg().Flim[:nf], Omega_0=JCfg().Omega_0[:nf]))
        tl = ThetaLayoutH.from_config(TCfg(**kw).replace(
            Flim=TCfg().Flim[:nf], Omega_0=TCfg().Omega_0[:nf]))
        for seed in range(4):
            r_jax, r_port = (np.random.default_rng(seed) for _ in range(2))
            want = jcal._draw_hier_truth(r_jax, jl, block=256)
            np.testing.assert_array_equal(
                tcal._draw_hier_truth(r_port, tl, block=256), want)
            assert want.shape == (tl.ndim,)
            assert r_port.random() == r_jax.random()


def test_sbc_replicate_matches_jax(sbc_runs):
    (r_j, c_j, n_j, tau_j), chain_j, (r_t, c_t, n_t, tau_t), chain_t = \
        sbc_runs
    _same_chain(chain_t, chain_j)
    np.testing.assert_array_equal(r_t, r_j)
    assert c_t == c_j and n_t == n_j and 2000 < n_t < 20000
    np.testing.assert_allclose(tau_t, tau_j, rtol=1e-8)


def test_sbc_replicate_h_matches_jax(hier_runs):
    (r_j, c_j, n_j, tau_j), chain_j, (r_t, c_t, n_t, tau_t), chain_t = \
        hier_runs
    _same_chain(chain_t, chain_j)
    assert chain_t.shape[-1] == 9          # 2 fields, free sch_al
    np.testing.assert_array_equal(r_t, r_j)
    assert c_t == c_j and n_t == n_j
    np.testing.assert_allclose(tau_t, tau_j, rtol=1e-8)


def test_coverage_replicate_z_matches_jax():
    (c_j, names_j), chain_j, (c_t, names_t), chain_t = _both(
        "coverage_replicate_z", 17, 2, n_target=200, nwalkers=16,
        nsteps=50, pad=64, size_ln=21)
    _same_chain(chain_t, chain_j)
    assert names_t == names_j and len(names_t) == 7
    assert c_t == c_j


def test_coverage_check_z_replicate_matches_jax():
    """The z example keeps its own replicate (``examples/coverage_check_z.py``
    of both packages): in the pivot parameterization it is
    ``coverage_replicate_z`` at the example's gauss-32 grid."""
    from lumfuncmcmc_tpu_torch.examples import coverage_check_z
    (c_j, names_j), chain_j, (c_t, names_t), chain_t = _both(
        "coverage_replicate_z", 11, 1, coverage_check_z.one_replicate,
        jax_kw={"size_ln": 32}, n_target=200, nwalkers=16, nsteps=50,
        pad=64)
    _same_chain(chain_t, chain_j)
    assert names_t == names_j and c_t == c_j


@pytest.mark.parametrize("free,move", [(False, "stretch"), (True, "stretch"),
                                       (False, "mix"), (True, "mix")])
def test_coverage_replicate_matches_jax(free, move):
    c_j, chain_j, c_t, chain_t = _both(
        "coverage_replicate", 11, 3, free=free, move=move, n_target=150,
        nwalkers=20, nsteps=40, pad=64)
    _same_chain(chain_t, chain_j)
    assert c_t == c_j and len(c_t) == (9 if free else 3)


def _res(kind, lo, hi):
    """A Laplace dict near the top of the first axis, so some draws
    leave the box and take the fallback."""
    d = len(lo)
    theta = (lo + hi) / 2.0
    theta[0] = hi[0] - 0.03
    a = np.diag((0.08 * (hi - lo)) ** 2)
    a[0, 1] = a[1, 0] = 0.3 * np.sqrt(a[0, 0] * a[1, 1])
    return {"theta": theta, "cov": a, "hess_ok": kind != "no_hessian",
            "boundary": np.arange(d) == (1 if kind == "boundary" else -1)}


@pytest.mark.parametrize("kind", ["laplace", "boundary", "no_hessian"])
def test_init_map_start_matches_jax_construction(kind):
    """JAX's start (``calibration.py:302-322``) from one Laplace dict,
    captured at its run step, equals the port's :func:`_map_start` of the
    same dict and the same normal and uniform draws (the JAX BFGS itself
    is not held bit for bit: ROADMAP C.2)."""
    import lumfuncmcmc_tpu.models.mapfit as jmap
    from lumfuncmcmc_tpu.models.likelihood import sample_init
    k, nw = 3, 16
    seen = {}

    def fake_laplace(lnpost, lo, hi, key, nstarts):
        assert nstarts == 4
        lo, hi = np.asarray(lo), np.asarray(hi)
        seen["res"] = _res(kind, lo, hi)
        seen["lo"], seen["hi"] = lo, hi
        return seen["res"]

    def stop(lnprob, pos0, key, nsteps, move="stretch"):
        raise _Stop(np.asarray(pos0))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmap, "laplace_fit", fake_laplace)
        mp.setattr(jcal, "run_stretch", stop)
        with pytest.raises(_Stop) as stopped:
            jcal.coverage_replicate(k, np.random.default_rng(0),
                                    init_map=True, n_target=150,
                                    nwalkers=nw, nsteps=10, pad=64)
    want = stopped.value.args[0]
    from lumfuncmcmc_tpu.config import LFConfig as JCfg
    from lumfuncmcmc_tpu.models.likelihood import ThetaLayout as JLay
    layout = JLay.from_config(JCfg(min_comp_frac=0.5, fix_comp=True))
    u = np.asarray(sample_init(jax.random.PRNGKey(3 * k + 7), layout, nw))
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(2 * k),
                                     (nw, layout.ndim), dtype=jnp.float64))
    got = tcal._map_start(seen["res"], torch.as_tensor(np.array(z)),
                          torch.as_tensor(u), torch.as_tensor(seen["lo"]),
                          torch.as_tensor(seen["hi"]))
    if kind != "laplace":
        assert got is None
        np.testing.assert_array_equal(want, u)
        return
    # float64 rounding of the same products: a few ulp of |theta| ~ 42
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # both branches of the box test ran
    fallback = 0.8 * (seen["lo"] + seen["hi"]) / 2.0 + 0.2 * u
    assert 0 < (want == fallback).sum() < want.size


def test_init_map_replicate_takes_the_laplace_start(caplog):
    """The port's replicate wires its own ``laplace_fit`` (4 starts, the
    generator seeded 5k+3) into :func:`_map_start` with its normal draws
    (seed 2k) and uniform starts (seed 3k+7), and says which start ran."""
    import lumfuncmcmc_tpu_torch.models.mapfit as tmap
    k, nw, seen = 1, 16, {}
    real = tmap.laplace_fit

    def laplace(*a, **kw):
        assert kw["nstarts"] == 4
        seen["res"] = real(*a, **kw)
        return seen["res"]

    def stop(lnprob, pos0, generator, nsteps, move="stretch"):
        raise _Stop(pos0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmap, "laplace_fit", laplace)
        mp.setattr(tcal, "_run", stop)
        with pytest.raises(_Stop) as stopped:
            tcal.coverage_replicate(k, np.random.default_rng(0),
                                    init_map=True, n_target=150,
                                    nwalkers=nw, nsteps=10, pad=64,
                                    device="cpu")
    res = seen["res"]
    assert res["hess_ok"] and not res["boundary"].any()
    from lumfuncmcmc_tpu_torch.config import LFConfig
    from lumfuncmcmc_tpu_torch.models.likelihood import (
        ThetaLayout, sample_init)
    layout = ThetaLayout.from_config(LFConfig(min_comp_frac=0.5,
                                              fix_comp=True))
    lo, hi = layout.bounds_arrays(torch.float64, "cpu")
    u = sample_init(torch.Generator().manual_seed(3 * k + 7), layout, nw)
    z = torch.randn((nw, 3), generator=torch.Generator().manual_seed(2 * k),
                    dtype=torch.float64)
    torch.testing.assert_close(stopped.value.args[0],
                               tcal._map_start(res, z, u, lo, hi),
                               rtol=0, atol=0)


@pytest.mark.parametrize("free", [False, True])
def test_pallas_replicate_takes_the_plain_kernel_versions_on_the_cpu(free):
    """``pallas=True`` on the CPU runs the value kernel's plain version on
    the padded context; its lnprob at JAX's start matches JAX's
    ``make_pallas_lnprob`` in interpret mode (rtol 5e-4, as
    ``test_plain_kernel_versions_match_pallas_interpret_f32``), and the
    replicate runs to its end through it. The fixed-completeness case
    pins the collapsed ln-term's sums to the real sources: padded rows
    once entered ``sum(lum - lref)``, which left every 68% interval of
    ``coverage_check 40`` on the card off its truth."""
    k, kw = 4, dict(free=free, pallas=True, n_target=150, nwalkers=16,
                    nsteps=12, pad=64)

    def stop(lnprob, pos0, key, nsteps, move="stretch"):
        raise _Stop(lnprob, np.asarray(pos0))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcal, "run_stretch", stop)
        with pytest.raises(_Stop) as stopped:
            jcal.coverage_replicate(k, np.random.default_rng(2), **kw)
    jlnprob, jpos0 = stopped.value.args
    want = np.asarray(jlnprob(jnp.asarray(jpos0)))
    seen = {}
    real = tcal._run

    def run(lnprob, pos0, generator, nsteps, move="stretch"):
        seen["engine"] = lnprob.engine
        seen["lnp"] = lnprob(torch.as_tensor(jpos0, dtype=pos0.dtype))
        seen["chain"] = real(lnprob, pos0, generator, nsteps, move)
        return seen["chain"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcal, "_run", run)
        cover = tcal.coverage_replicate(k, np.random.default_rng(2),
                                        device="cpu", **kw)
    assert seen["engine"] == "plain"
    got = seen["lnp"].numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=5e-4)
    ndim = 9 if free else 3
    assert seen["chain"].shape == (12, 16, ndim)
    assert np.isfinite(seen["chain"]).all() and len(cover) == ndim


def test_replicate_without_a_card_names_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcal.sbc_replicate(0, np.random.default_rng(0), nwalkers=8,
                           nsteps=10, size_ln=11)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcal.coverage_replicate(0, np.random.default_rng(0), n_target=100,
                                nwalkers=8, nsteps=10, pad=64)


# tests/test_calibration.py's gates, on the port (docstrings there give
# the flake budgets: < 2%, < 0.5%, < 1%)
K, M = 12, 7


@pytest.mark.slow
def test_calibration_smoke_coverage_and_sbc_ranks():
    rng = np.random.default_rng(7)
    ranks = np.empty((K, len(tcal.PARAMS)), dtype=int)
    hits68 = np.zeros(len(tcal.PARAMS), dtype=int)
    hits95 = np.zeros(len(tcal.PARAMS), dtype=int)
    for k in range(K):
        r, cover, _, _ = tcal.sbc_replicate(k, rng, nwalkers=32, nsteps=400,
                                            M=M, size_ln=41, device="cpu")
        ranks[k] = r
        for i, nm in enumerate(tcal.PARAMS):
            hits68[i] += cover[nm][0]
            hits95[i] += cover[nm][1]
    for i, nm in enumerate(tcal.PARAMS):
        assert hits68[i] >= 4, f"{nm}: 68% covered {hits68[i]}/{K}"
        assert hits95[i] >= 7, f"{nm}: 95% covered {hits95[i]}/{K}"
        mean_rank = float(ranks[:, i].mean())
        assert 1.5 <= mean_rank <= 5.5, f"{nm}: mean rank {mean_rank:.2f}"
    assert hits68.sum() <= 33, f"pooled 68% coverage {hits68.sum()}/36"


@pytest.mark.slow
def test_calibration_z_model_coverage():
    Kz = 8
    rng = np.random.default_rng(17)
    hits68 = hits95 = None
    for k in range(Kz):
        cover, names = tcal.coverage_replicate_z(k, rng, device="cpu")
        if hits68 is None:
            hits68 = {p: 0 for p in names}
            hits95 = {p: 0 for p in names}
        for p in names:
            hits68[p] += cover[p][0]
            hits95[p] += cover[p][1]
    for p in names:
        assert hits68[p] >= 1, f"{p}: 68% never covered in {Kz}"
        assert hits95[p] >= 5, f"{p}: 95% covered {hits95[p]}/{Kz}"
    pooled = sum(hits68.values())
    assert 24 <= pooled <= 7 * Kz - 1, f"pooled 68% {pooled}/{7 * Kz}"


@pytest.mark.slow
def test_calibration_hier_sbc_ranks_and_coverage():
    Kh = 10
    rng = np.random.default_rng(23)
    ranks, hits68, hits95, names = [], None, None, None
    for k in range(Kh):
        r, cover, _, _ = tcal.sbc_replicate_h(k, rng, device="cpu")
        ranks.append(r)
        if hits68 is None:
            names = list(cover)
            hits68 = {p: 0 for p in names}
            hits95 = {p: 0 for p in names}
        for p in names:
            hits68[p] += cover[p][0]
            hits95[p] += cover[p][1]
    ranks = np.asarray(ranks)
    for i, p in enumerate(names):
        mean_rank = float(ranks[:, i].mean())
        assert 1.0 <= mean_rank <= 6.0, f"{p}: mean rank {mean_rank:.2f}"
        assert hits68[p] >= 2, f"{p}: 68% covered {hits68[p]}/{Kh}"
        assert hits95[p] >= 6, f"{p}: 95% covered {hits95[p]}/{Kh}"
