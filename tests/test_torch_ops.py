"""PyTorch port vs JAX package: cosmology, interpolation and the math
ops, float64 on the CPU (rtol 1e-12: the same formulas, rounding only);
plus the port's import hygiene and its no-fallback dispatch rule."""

import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu import cosmology as jcosmo
from lumfuncmcmc_tpu.ops import quadrature as jquad
from lumfuncmcmc_tpu_torch import cosmology as tcosmo
from lumfuncmcmc_tpu_torch.ops import completeness as tcomp
from lumfuncmcmc_tpu_torch.ops import quadrature as tquad

# both ops packages re-export functions under these module names
jcomp = importlib.import_module("lumfuncmcmc_tpu.ops.completeness")
jsch = importlib.import_module("lumfuncmcmc_tpu.ops.schechter")
jomega = importlib.import_module("lumfuncmcmc_tpu.ops.omega")
tomega = importlib.import_module("lumfuncmcmc_tpu_torch.ops.omega")
tsch = importlib.import_module("lumfuncmcmc_tpu_torch.ops.schechter")

torch.set_num_threads(2)
RTOL = 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def close(got, want, rtol=RTOL, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def test_interp_matches_jnp_interp_with_clamping():
    rng = np.random.default_rng(1)
    xp = np.sort(rng.uniform(-2.0, 3.0, 200))
    fp = np.cumsum(rng.normal(size=200))
    # inside, outside on both sides, and exactly on nodes and ends
    x = np.concatenate([rng.uniform(-4.0, 5.0, 500), xp[::17],
                        [xp[0], xp[-1]]])
    close(tcosmo.interp(t64(x), t64(xp), t64(fp)),
          jnp.interp(x, xp, fp))


def test_cosmo_arrays_and_table_methods():
    tabs_j = jcosmo.build_cosmo_arrays(zmax=2.1)
    tabs_t = tcosmo.build_cosmo_arrays(zmax=2.1)
    for k in tcosmo.COSMO_FIELDS:
        np.testing.assert_array_equal(tabs_t[k], tabs_j[k])
    jt = jcosmo.build_cosmo_table(2.1, dtype=jnp.float64)
    tt = tcosmo.cosmo_table_from_arrays(tabs_t, "cpu", torch.float64)
    z = np.linspace(0.01, 2.3, 97)
    for name in ("luminosity_distance", "log10_dl_cm_at",
                 "differential_comoving_volume"):
        close(getattr(tt, name)(t64(z)), getattr(jt, name)(z))
    close(tt.comoving_volume_between(t64(z[:40]), t64(z[40:80])),
          jt.comoving_volume_between(z[:40], z[40:80]))
    logdl = np.linspace(26.0, 29.0, 55)
    close(tt.z_at_log10_dl_cm(t64(logdl)), jt.z_at_log10_dl_cm(logdl))
    assert tcosmo.SQARCSEC_PER_SR == jcosmo.SQARCSEC_PER_SR


def test_schechter_forms():
    rng = np.random.default_rng(2)
    logL = rng.uniform(40.0, 45.0, (7, 13))
    al, ls, ps = -1.3, 42.4, -3.1
    close(tsch.log_true_lum_func(t64(logL), al, ls, ps),
          jsch.log_true_lum_func(logL, al, ls, ps))
    close(tsch.true_lum_func(t64(logL), al, ls, ps),
          jsch.true_lum_func(logL, al, ls, ps))
    assert tsch.LN10 == jsch.LN10


@pytest.mark.parametrize("fcmin", [0.1, 0.0, 0.7])
def test_fleming_curves(fcmin):
    rng = np.random.default_rng(3)
    logf = rng.uniform(-19.0, -14.0, 300)
    lf50 = np.log10(3.1e-17)
    alpha = t64(4.2)
    # atol: XLA flushes float64 subnormals (~1e-313) to zero, torch not
    close(tcomp.fleming_from_logf(t64(logf), lf50, alpha, fcmin),
          jcomp.fleming_from_logf(jnp.asarray(logf), lf50, 4.2, fcmin),
          atol=1e-300)
    np.testing.assert_array_equal(
        tcomp.fleming_from_logf_np(logf, lf50, 4.2, fcmin),
        jcomp.fleming_from_logf_np(logf, lf50, 4.2, fcmin))
    if fcmin:
        close(tcomp._log10_inverse_fleming_ratio(t64([2.0, 4.5]), fcmin),
              jcomp._log10_inverse_fleming_ratio(jnp.asarray([2.0, 4.5]),
                                                 fcmin))
        np.testing.assert_array_equal(
            tcomp.fleming_root_logf_np([lf50, lf50 + 0.2], 4.2, 0.5, fcmin),
            jcomp.fleming_root_logf_np([lf50, lf50 + 0.2], 4.2, 0.5, fcmin))
    close(tcomp.expdecay(t64(logf + 20.0), 1.7),
          jcomp.expdecay(jnp.asarray(logf + 20.0), 1.7))


def test_omega_and_flux_conversions():
    rng = np.random.default_rng(4)
    logL = rng.uniform(41.0, 44.0, 50)
    logdl = rng.uniform(27.5, 28.5, 50)
    logf = tomega.logflux_from_loglum(t64(logL), t64(logdl))
    close(logf, jomega.logflux_from_loglum(logL, logdl))
    close(tomega.loglum_from_logflux(logf, t64(logdl)), logL)
    close(tomega.omega_from_logf(logf, 3e5, -16.5, t64(4.56), 0.1),
          jomega.omega_from_logf(jnp.asarray(logf.numpy()), 3e5, -16.5,
                                 4.56, 0.1))
    assert tomega.LOG10_4PI == jomega.LOG10_4PI


def test_quadrature():
    u_t, w_t = tquad.gl_nodes_unit(24)
    u_j, w_j = jquad.gl_nodes_unit(24)
    np.testing.assert_array_equal(u_t, u_j)
    np.testing.assert_array_equal(w_t, w_j)
    lo, hi = np.array([0.1, 0.5]), np.array([1.3, 2.0])
    close(tquad.integrate_gl_unit(torch.sin, 32, t64(lo), t64(hi)),
          jquad.integrate_gl_unit(jnp.sin, 32, jnp.asarray(lo),
                                  jnp.asarray(hi)))


def test_port_never_imports_jax():
    """Importing the port and every one of its modules leaves jax and the
    JAX package out of sys.modules (fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import lumfuncmcmc_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.') if not m.name.endswith('__main__')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) > 20, names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'lumfuncmcmc_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_cuda_tensor_never_falls_back_to_the_plain_version(monkeypatch):
    """A non-CPU tensor takes the kernel route or raises: here a fake
    CUDA tensor (no card) and a meta tensor both raise, and a missing
    nvcc is an error, not a silent CPU run."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from lumfuncmcmc_tpu.config import LFConfig
    from lumfuncmcmc_tpu_torch.models.context import build_context
    from lumfuncmcmc_tpu_torch.ops import _build
    from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
    from lumfuncmcmc_tpu_torch.utils.synth import (
        apply_completeness_cut, make_catalog)

    cfg = LFConfig(min_comp_frac=0.5, size_ln=11)
    cat = apply_completeness_cut(make_catalog(cfg, n_target=80, seed=1),
                                 cfg)
    _, ctx = build_context(cfg, z=cat["z"], flux=cat["flux"],
                           field_id=cat["field_id"])
    data = cl.prepare_cuda_data(ctx, False, cfg.fcmin)
    fixed = cl.prepare_cuda_data(ctx, True)
    with pytest.raises(ValueError, match="unsupported device"):
        cl.free_lnlike(torch.zeros((4, 16), device="meta"), data)
    with pytest.raises(ValueError, match="unsupported device"):
        cl.fixed_lnlike(torch.zeros((4, 4), device="meta"), fixed)
    with FakeTensorMode(allow_non_fake_inputs=True):
        feats = torch.zeros((4, 16), device="cuda")
        with pytest.raises(ValueError, match="grid data on cpu"):
            cl.free_lnlike(feats, data)
    assert cl.free_lnlike.launches == 0 and cl.fixed_lnlike.launches == 0
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
