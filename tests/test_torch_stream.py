"""PyTorch port vs JAX package: the streaming free-completeness path of
mega catalogs (``free_stream_lnlike``, ``free_stream_lnlike_vg`` and their
per-shard layout).

Both sides compute on identical grids (``context_from_arrays``); the JAX
kernels run in interpret mode. Tolerances:

- the port's float32 plain streaming versions at theta level vs
  ``_make_stream_lnlike`` / ``_make_stream_vg_scalar``, per shard vs
  ``make_stream_shard_batched`` / ``make_stream_shard_vg`` at 2 and 3
  shards, and vs the float64 XLA lnprob: values rtol 5e-4 (the JAX
  package's own Pallas bar), theta-gradients by ``_grad_close`` at 2e-3;
- the port against itself in float64 (plain streaming vs plain resident
  vs the eager engine, the sum over shards vs one shard): 1e-10, the
  same sums in another order;
- the sum over shards of the float32 versions vs one shard: 1e-6.

fcmin = 0 is compared with the port's float64 eager engine (the JAX
Pallas feature map raises ZeroDivisionError there, ROADMAP §C).
"""

import functools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lumfuncmcmc_tpu.ops.pallas_lnlike as pk
from lumfuncmcmc_tpu.config import LFConfig
from lumfuncmcmc_tpu.models import likelihood as jlik
from lumfuncmcmc_tpu.models.context import build_context as jax_build
from lumfuncmcmc_tpu.utils.synth import apply_completeness_cut, make_catalog
from lumfuncmcmc_tpu_torch import LFConfig as TLFConfig
from lumfuncmcmc_tpu_torch.cli.main import main as port_main
from lumfuncmcmc_tpu_torch.cosmology import COSMO_FIELDS
from lumfuncmcmc_tpu_torch.models import likelihood as tlik
from lumfuncmcmc_tpu_torch.models.context import (
    CTX_FIELDS, build_context, context_from_arrays)
from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.utils import synth as tsynth

torch.set_num_threads(2)
RTOL = 5e-4


@functools.lru_cache(maxsize=None)
def _setup(fcmin=0.1, quadrature="trapz", size_ln=21, n=300, seed=3):
    cfg = LFConfig(min_comp_frac=0.5, size_ln=size_ln, fcmin=fcmin,
                   quadrature=quadrature)
    cat = apply_completeness_cut(make_catalog(cfg, n_target=n, seed=seed),
                                 cfg)
    _, jctx = jax_build(cfg, z=cat["z"], flux=cat["flux"],
                        flux_e=cat["flux_e"], field_id=cat["field_id"],
                        dtype=jnp.float64)
    arrays = {f: np.asarray(getattr(jctx, f)) for f in CTX_FIELDS
              if f != "cosmo"}
    arrays["cosmo"] = {k: np.asarray(getattr(jctx.cosmo, k))
                       for k in COSMO_FIELDS}
    ctx = {dt: context_from_arrays(arrays, "cpu", dt)
           for dt in (torch.float32, torch.float64)}
    return cfg, jctx, jlik.ThetaLayout.from_config(cfg), ctx


def _central(layout, w, seed, keep=0.3):
    """Prior draws shrunk toward the box centre (``tests/test_pallas.py``
    does the same), as float32 values so both sides see one theta."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(layout.lo), np.asarray(layout.hi)
    th = lo + rng.uniform(size=(w, layout.ndim)) * (hi - lo)
    th = (1 - keep) * 0.5 * (lo + hi)[None, :] + keep * th
    return th.astype(np.float32).astype(np.float64)


def _grad_close(gp, gref, rtol=2e-3):
    """The JAX package's gradient gate (``tests/test_pallas.py:151``)."""
    denom = np.maximum(np.abs(gref),
                       1e-3 * np.abs(gref).max(axis=-1, keepdims=True))
    np.testing.assert_array_less(np.abs(gp - gref) / denom, rtol)


def _stream(monkeypatch, ctx, layout, grad=False):
    """The port's lnprob through the streaming path (gate lowered)."""
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES", 0)
    fn = cl._make_lnprob(ctx, layout, "single", grad)
    assert fn.engine == "plain-stream"
    return fn


def _port_vg(fn, th, dtype):
    t = torch.tensor(th, dtype=dtype, requires_grad=True)
    v = fn(t)
    (g,) = torch.autograd.grad(v.sum(), t)
    return v.detach().numpy(), g.numpy()


@pytest.mark.parametrize("quadrature", ["trapz", "gauss"])
def test_stream_value_matches_pallas_interpret_and_xla(monkeypatch,
                                                       quadrature):
    cfg, jctx, jlayout, ctx = _setup(quadrature=quadrature,
                                     size_ln=21 if quadrature == "trapz"
                                     else 12)
    layout = tlik.ThetaLayout.from_config(cfg)
    th = _central(jlayout, 11, 0)
    got = _stream(monkeypatch, ctx[torch.float32], layout)(
        torch.tensor(th, dtype=torch.float32)).numpy()
    pal = np.asarray(pk._make_stream_lnlike(jctx, jlayout, interpret=True,
                                            blk=None)(
        jnp.asarray(th, jnp.float32)))
    xla = np.asarray(jax.vmap(jlik.make_lnprob(jctx, jlayout))(
        jnp.asarray(th)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, pal, rtol=RTOL)
    np.testing.assert_allclose(got, xla, rtol=RTOL)


def test_stream_value_and_grad_match_pallas_interpret(monkeypatch):
    cfg, jctx, jlayout, ctx = _setup()
    layout = tlik.ThetaLayout.from_config(cfg)
    th = _central(jlayout, 5, 1)
    v, g = _port_vg(_stream(monkeypatch, ctx[torch.float32], layout,
                            grad=True), th, torch.float32)
    pal = pk._make_stream_vg_scalar(jctx, jlayout, interpret=True)
    jv, jg = jax.vmap(jax.value_and_grad(pal))(jnp.asarray(th, jnp.float32))
    np.testing.assert_allclose(v, np.asarray(jv), rtol=RTOL)
    _grad_close(g, np.asarray(jg))
    xv, xg = jax.vmap(jax.value_and_grad(jlik.make_lnprob(jctx, jlayout)))(
        jnp.asarray(th))
    np.testing.assert_allclose(v, np.asarray(xv), rtol=RTOL)
    _grad_close(g, np.asarray(xg))


def test_stream_out_of_box_is_minus_inf_with_a_zero_gradient(monkeypatch):
    cfg, _, jlayout, ctx = _setup()
    layout = tlik.ThetaLayout.from_config(cfg)
    th = _central(jlayout, 4, 2)
    th[0, 0] = layout.hi[0] + 1.0           # Lstar out of the box
    th[1, 3] = -1.0                         # a negative Flim
    for dt in (torch.float32, torch.float64):
        v, g = _port_vg(_stream(monkeypatch, ctx[dt], layout, grad=True),
                        th, dt)
        assert np.isneginf(v[:2]).all() and np.isfinite(v[2:]).all()
        assert (g[:2] == 0).all() and np.isfinite(g).all()
        assert (g[2:] != 0).any()


def _jax_shard_vg_scalar(jctx, jlayout, nshards):
    """theta -> the sum over shards of ``make_stream_shard_vg``'s rows,
    through the JAX package's own custom_vjp plumbing."""
    vg_rows, s_stacked, feat_one = pk.make_stream_shard_vg(
        jctx, jlayout, nshards, interpret=True)

    def rows(feats):
        return sum(vg_rows(feats, tuple(s[k] for s in s_stacked))
                   for k in range(nshards))

    return pk._vg_scalar_from_rows(rows, feat_one, lambda th, lnl: lnl)


@pytest.mark.parametrize("nshards", [2, 3])
def test_shards_match_the_pallas_shard_kernels(nshards):
    cfg, jctx, jlayout, ctx = _setup()
    layout = tlik.ThetaLayout.from_config(cfg)
    th = _central(jlayout, 5, 3)
    data = cl.prepare_cuda_stream_data(ctx[torch.float32], cfg.fcmin,
                                       nshards=nshards)
    one = cl.prepare_cuda_stream_data(ctx[torch.float32], cfg.fcmin)
    batched, s_stacked = pk.make_stream_shard_batched(
        jctx, jlayout, nshards, interpret=True)
    t = torch.tensor(th, dtype=torch.float32, requires_grad=True)
    feats = cl._features_stream(t, data, layout, torch.float32)
    total = 0.0
    for k in range(nshards):
        got = (cl.free_stream_lnlike(feats.float().detach(), data, k)
               + cl._stream_collapsed(feats.detach(), data, k))
        want = np.asarray(batched(jnp.asarray(th, jnp.float32),
                                  tuple(s[k] for s in s_stacked)))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
        total = total + cl._stream_collapsed(feats, data, k) + \
            cl._LnlikeOfFeats.apply(
                feats, data,
                lambda f, d, k=k: cl.free_stream_lnlike_vg(f, d, k))
    (g,) = torch.autograd.grad(total.sum(), t)
    f1 = cl._features_stream(torch.tensor(th), one, layout, torch.float32)
    whole = cl.free_stream_lnlike(f1.float(), one) + \
        cl._stream_collapsed(f1, one)
    np.testing.assert_allclose(total.detach().numpy(), whole.numpy(),
                               rtol=1e-6)
    jv, jg = jax.vmap(jax.value_and_grad(
        _jax_shard_vg_scalar(jctx, jlayout, nshards)))(
        jnp.asarray(th, jnp.float32))
    np.testing.assert_allclose(total.detach().numpy(), np.asarray(jv),
                               rtol=RTOL)
    _grad_close(g.numpy(), np.asarray(jg))


def test_shard_layout_deals_each_field_round_robin():
    """Shard k holds sources k, k + n, ... of every field, each field
    padded to whole tiles with mask 0, at offsets every shard shares."""
    cfg, _, _, ctx = _setup()
    c = ctx[torch.float64]
    data = cl.prepare_cuda_stream_data(c, cfg.fcmin, nshards=3)
    fid = c.field_id.numpy()
    assert data.s_logf.shape == (3, data.src_off[-1])
    assert all((b - a) % cl.CHUNK_CELLS == 0
               for a, b in zip(data.src_off[:-1], data.src_off[1:]))
    logf = c.logf_src.numpy() - cl._LOGF_REF
    for f in range(data.nfields):
        sel = np.nonzero(fid == f)[0]
        for k in range(3):
            n = len(sel[k::3])
            row = data.s_logf[k, data.src_off[f]:data.src_off[f + 1]]
            np.testing.assert_array_equal(row[:n].numpy(), logf[sel[k::3]])
            m = data.s_mask[k, data.src_off[f]:data.src_off[f + 1]].numpy()
            assert m[:n].all() and not m[n:].any()
    np.testing.assert_allclose(data.sums[:, 0].sum().item(), len(fid))
    src_runs = data.runs[data.runs[:, 3] == 1]
    assert int(src_runs[:, 2].max()) == data.src_off[-1]
    one = cl.prepare_cuda_stream_data(c, cfg.fcmin)
    np.testing.assert_allclose(data.g_w.numpy() * 3, one.g_w.numpy(),
                               rtol=1e-15)


@pytest.mark.parametrize("nshards", [1, 3])
def test_run_table_cuts_each_field_into_runs_of_whole_tiles(nshards):
    """The kernels' run table covers every grid cell and source slot once,
    each run inside one field and of one kind, a source run a whole number
    of tiles (at most ``run_pieces``) from a tile boundary, grid runs
    first, each kind field by field. The run length is the fewest tiles
    that fit the source runs in half of the value kernel's wave; off the
    card there is no wave, and runs are as long as a block can stage."""
    cfg, _, _, ctx = _setup()
    data = cl.prepare_cuda_stream_data(ctx[torch.float64], cfg.fcmin,
                                       nshards=nshards)
    runs = data.runs.numpy()
    assert runs.dtype == np.int32 and runs.shape[1] == 4
    assert 1 <= data.run_pieces <= cl.STREAM_MAX_RUN
    cover = {0: np.zeros(data.g_a.numel(), int),
             1: np.zeros(data.s_logf.shape[1], int)}
    for fld, a, b, src in runs:
        off = data.src_off if src else data.grid_off
        assert off[fld] <= a < b <= off[fld + 1]
        assert b - a <= data.run_pieces * cl.CHUNK_CELLS
        if src:
            assert (a - off[fld]) % cl.CHUNK_CELLS == 0
            assert (b - a) % cl.CHUNK_CELLS == 0
        cover[int(src)][a:b] += 1
    assert (cover[0] == 1).all() and (cover[1] == 1).all()
    order = np.lexsort((runs[:, 1], runs[:, 0], runs[:, 3]))
    np.testing.assert_array_equal(order, np.arange(len(runs)))
    assert data.run_pieces == cl.STREAM_MAX_RUN and data.waves == (0, 0)
    assert cl._run_pieces(400, lambda rp: 528) == 2
    assert cl._run_pieces(10, lambda rp: 528) == 1
    assert cl._run_pieces(10**6, lambda rp: 528) == cl.STREAM_MAX_RUN
    assert cl._run_pieces(400, {1: 600, 2: 300, 3: 300, 4: 99}.get) == 3


@pytest.mark.parametrize("fcmin", [0.1, 0.0])
def test_plain_stream_equals_resident_and_eager_in_float64(monkeypatch,
                                                           fcmin):
    """Value and theta-gradient, at 1 and 3 shards, at 1e-10: fcmin = 0
    is held to the eager engine here."""
    cfg, _, jlayout, ctx = _setup(fcmin=fcmin)
    layout = tlik.ThetaLayout.from_config(cfg)
    c = ctx[torch.float64]
    th = _central(jlayout, 6, 4)
    v_s, g_s = _port_vg(_stream(monkeypatch, c, layout, grad=True), th,
                        torch.float64)
    val_s = _stream(monkeypatch, c, layout)(torch.tensor(th)).numpy()
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES", 10**9)
    v_r, g_r = _port_vg(cl.make_cuda_lnprob_and_grad(c, layout), th,
                        torch.float64)
    v_e, g_e = _port_vg(tlik.make_lnprob(c, layout), th, torch.float64)
    for v, g in ((v_r, g_r), (v_e, g_e)):
        np.testing.assert_allclose(v_s, v, rtol=1e-10)
        np.testing.assert_allclose(val_s, v, rtol=1e-10)
        _grad_close(g_s, g, rtol=1e-10)
    d3 = cl.prepare_cuda_stream_data(c, cfg.fcmin, nshards=3)
    f = cl._features_stream(torch.tensor(th), d3, layout, torch.float64)
    tot = sum(cl.free_stream_lnlike(f, d3, k) + cl._stream_collapsed(f, d3, k)
              for k in range(3))
    np.testing.assert_allclose(tot.numpy(), v_e, rtol=1e-10)


def test_make_lnprob_routes_by_stream_min_sources(monkeypatch):
    cfg, _, _, ctx = _setup()
    c = ctx[torch.float64]
    nsrc = c.lum.shape[0]
    layout = tlik.ThetaLayout.from_config(cfg)
    fixed = tlik.ThetaLayout.from_config(cfg.replace(fix_comp=True))
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES", nsrc + 1)
    assert cl.make_cuda_lnprob(c, layout).engine == "plain"
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES", nsrc)
    counts = np.bincount(c.field_id.numpy())
    tiles = int(sum(-(-n // cl.CHUNK_CELLS) for n in counts))
    for fn in (cl.make_cuda_lnprob(c, layout),
               cl.make_cuda_lnprob_and_grad(c, layout)):
        assert fn.engine == "plain-stream"
        assert fn.stream == (nsrc, tiles)
    # fixed completeness has no source term to stream
    assert cl.make_cuda_lnprob(c, fixed).engine == "plain"


def _emulation(n_target=200_000):
    """Thetas near the truth of a ~170,000-source catalog in 4 close
    pairs, and the float64 eager lnprob there."""
    cfg = TLFConfig(min_comp_frac=0.5, quadrature="gauss")
    cat = tsynth.apply_completeness_cut(
        tsynth.make_catalog(cfg, n_target=n_target, seed=7), cfg)
    kw = dict(z=cat["z"], flux=cat["flux"], flux_e=cat["flux_e"],
              field_id=cat["field_id"])
    tt = cat["theta_true"]
    c = np.array([tt["Lstar"], tt["phistar"], tt["sch_al"], *cfg.Flim,
                  cfg.alpha])
    rng = np.random.default_rng(1)
    base = c + rng.normal(0, 1, (4, 9)) * np.array([2e-3] * 3 + [5e-3] * 6)
    th = torch.tensor(np.concatenate(
        [base, base + rng.normal(0, 3e-4, (4, 9))]))
    layout = tlik.ThetaLayout.from_config(cfg)
    _, c64 = build_context(cfg, dtype=torch.float64, **kw)
    return cfg, layout, c64, th, tlik.make_lnprob(c64, layout)(th)


def test_float32_stream_resolves_lnp_differences_that_resident_loses(
        monkeypatch):
    """At 170,455 sources (|lnL| ~ 2.5e6) the float32 resident path is
    off by 0.20 in the lnp difference of close thetas, the float32
    streaming path (float64 sums, collapsed affine terms, logf relative
    to logf_ref) by 0.0025: held to 10x less, and under 0.02. At
    1,019,385 sources the same emulation gives 2.40 and 0.0064."""
    cfg, layout, c64, th, want = _emulation()

    def dlnp(v):
        return (v[4:] - v[:4]).numpy()

    # both engines' kernels in float32, as on the card
    data32 = cl.prepare_cuda_data(c64, False, cfg.fcmin,
                                  dtype=torch.float32)
    res = cl.free_lnlike(cl._features(th.float(), data32, layout,
                                      torch.float32).float(), data32)
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES", 0)
    stream = cl._make_lnprob(c64, layout, "single", False)
    sdata = cl.prepare_cuda_stream_data(c64, cfg.fcmin,
                                        dtype=torch.float32)
    f = cl._features_stream(th, sdata, layout, torch.float32)
    st = cl.free_stream_lnlike(f.float(), sdata) + \
        cl._stream_collapsed(f, sdata)
    err_res = np.abs(dlnp(res) - dlnp(want)).max()
    err_st = np.abs(dlnp(st) - dlnp(want)).max()
    assert err_st < 0.02 and err_st * 10 < err_res, (err_st, err_res)
    # the float64 lnprob of the same path is exact to float64 sums
    np.testing.assert_allclose(stream(th).numpy(), want.numpy(),
                               rtol=1e-12)


def test_fit_cli_takes_the_streaming_path_on_the_cpu(tmp_path, monkeypatch):
    """``fit --use-pallas`` with the gate lowered writes the JAX CLI's
    artifact set, and the log names the streaming engine; a short NUTS
    fit of the same model goes through the streaming value+gradient
    versions (the CLI's 200 warmup transitions take minutes here)."""
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES", 0)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(
        '{"use_x64": true, "output_dict": {"parameters": true, '
        '"settings": true, "fitposterior": true, "bestfitLF": true, '
        '"VeffLF": true, "triangle plot": false, "image format": "png"}}')
    lines = []

    class Grab(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log = logging.getLogger("lumfuncmcmc_tpu_torch")
    grab = Grab()
    log.addHandler(grab)
    monkeypatch.chdir(tmp_path)
    try:
        assert port_main(["fit", "--device", "cpu", "--use-pallas",
                          "--synthetic", "300", "-mcf", "0.5", "--size-ln",
                          "9", "--config", str(cfg_path), "-nw", "16",
                          "-ns", "60", "-o", "s.dat"]) == 0
        cfg = TLFConfig(min_comp_frac=0.5, size_ln=9, use_pallas=True,
                        nsteps=8)
        cat = tsynth.apply_completeness_cut(
            tsynth.make_catalog(cfg, n_target=300, seed=cfg.seed), cfg)
        model = LumFuncModel(cfg, z=cat["z"], flux=cat["flux"],
                             flux_e=cat["flux_e"], field_id=cat["field_id"],
                             device="cpu", dtype=torch.float64)
        samples = model.fit_model_nuts(num_warmup=20, nchains=2)
    finally:
        log.removeHandler(grab)
    engine = [ln for ln in lines if ln.startswith("Engine:")]
    assert len(engine) == 3 and all(
        "plain versions of the streaming kernels" in ln
        for ln in engine), engine
    assert any("dtype float64" in ln for ln in lines)
    tag = "s_nb50_nw16_ns60_mcf50"
    for name in (f"fitposterior_{tag}.dat", f"bestfitLF_{tag}.dat",
                 f"VeffLF_{tag}.dat", "s.dat", "s.dat.args"):
        assert os.path.isfile(tmp_path / "LFMCMCOut" / name), name
    assert samples.shape == (16, 10) and np.isfinite(samples).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_streaming_route_needs_a_float64_run(monkeypatch, dtype):
    """The route fixes the sampler's dtype: a float32 model refuses the
    streaming kernels (its lnp cannot resolve the accept step there),
    for the stretch and the NUTS engine alike; a float64 one takes them."""
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES", 0)
    cfg = TLFConfig(min_comp_frac=0.5, size_ln=9, use_pallas=True)
    cat = tsynth.apply_completeness_cut(
        tsynth.make_catalog(cfg, n_target=300, seed=cfg.seed), cfg)
    model = LumFuncModel(cfg, z=cat["z"], flux=cat["flux"],
                         flux_e=cat["flux_e"], field_id=cat["field_id"],
                         device="cpu", dtype=dtype)
    if dtype == torch.float32:
        for engine in (model.lnprob_batch, model._nuts_gradient_post):
            with pytest.raises(ValueError, match="use_x64"):
                engine()
    else:
        assert model.lnprob_batch().engine == "plain-stream"
        assert model._nuts_gradient_post().engine == "plain-stream"
