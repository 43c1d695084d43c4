"""PyTorch port vs JAX package: the ``vmax`` path (the standalone
1/V_eff pipeline).

Inputs are numpy-seeded and go through both packages on the CPU in
float64. Tolerances:

- ``upper_gamma`` over a in [-4, 1] and x in [1e-9, 2] (the Schechter
  forms call it at x <= 1e-4): rtol 1e-10, the same recurrence on two
  libraries' ``gammaincc``; 1e-7 within 1e-3 of an integer shape (the
  recurrence divides by a ~1e-8 nudge there, which amplifies the last
  bit of ``gammaincc``) and at x up to 30 (where it cancels); the four
  Schechter forms: 1e-10;
- ``linear_bin_edges`` / ``mult_factor`` / ``apply_partial_bin_correction``
  / ``equal_count_z_bins`` and the ``log_bins=False`` bootstrap (fed the
  same resample indices): 1e-12 on the same cosmology table, the
  bootstrap variance 1e-9;
- ``fit_schechter`` on a fixed binned LF, each parameterization: the
  optimum rtol 1e-5, ``chisqr`` 1e-6, ``stderr`` and the 3-sigma band 1e-3
  (the port's Jacobian is a central difference, the JAX package's
  autodiff; both stop at a relative cost change of 1e-12);
- the ``vmax`` CLI: the same files; ``Luminosity`` and ``BinLF`` rtol
  1e-9; ``BinLFErr`` (two different bootstrap draws of ``nboot`` = 100
  resamples, each sd known to ~7%) within 35% of the JAX package's in the
  median over bins; the fitted parameters within 1 standard error.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.cli.main import main as jax_main
from lumfuncmcmc_tpu.cosmology import build_cosmo_table
from lumfuncmcmc_tpu.models import schfit as jfit
from lumfuncmcmc_tpu.models import veff as jveff
from lumfuncmcmc_tpu.ops.gamma import upper_gamma as jax_upper_gamma
from lumfuncmcmc_tpu.utils.io import read_fixed_width_two_line
from lumfuncmcmc_tpu_torch.cli.main import main as port_main
from lumfuncmcmc_tpu_torch.cosmology import (
    COSMO_FIELDS, cosmo_table_from_arrays)
from lumfuncmcmc_tpu_torch.models import schfit as tfit
from lumfuncmcmc_tpu_torch.models import veff as tveff
from lumfuncmcmc_tpu_torch.ops.gamma import upper_gamma

import importlib
jsch = importlib.import_module("lumfuncmcmc_tpu.ops.schechter")
tsch = importlib.import_module("lumfuncmcmc_tpu_torch.ops.schechter")

torch.set_num_threads(2)

FORMS = [(False, False), (True, False), (False, True), (True, True)]
FORM_IDS = ["lin-phi", "log-phi", "lin-integ", "log-integ"]


def test_upper_gamma_matches_jax(rng):
    a = np.concatenate([rng.uniform(-4.0, 1.0, 400),
                        [-3.0, -2.0, -1.0, 0.0, 1.0, 0.5, -0.5, -3.5]])
    x = np.concatenate([10.0 ** rng.uniform(-9.0, 0.3, 400),
                        [1e-6, 0.3, 2.0, 1e-3, 5.0, 1e-6, 1e-6, 30.0]])
    got = upper_gamma(torch.tensor(a), torch.tensor(x))
    want = np.asarray(jax_upper_gamma(jnp.asarray(a), jnp.asarray(x)))
    assert got.dtype == torch.float64 and np.isfinite(want).all()
    easy = (np.abs(a - np.round(a)) > 1e-3) & (x <= 2.0)
    assert easy.sum() > 390
    np.testing.assert_allclose(got.numpy()[easy], want[easy], rtol=1e-10)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7)
    # broadcasting and Python numbers, as the Schechter forms call it
    np.testing.assert_allclose(
        upper_gamma(-0.7, torch.tensor(x[:5])).numpy(),
        np.asarray(jax_upper_gamma(-0.7, jnp.asarray(x[:5]))), rtol=1e-10)
    np.testing.assert_allclose(float(upper_gamma(-1.3, 1e-6)),
                               float(jax_upper_gamma(-1.3, 1e-6)),
                               rtol=1e-10)
    # float32 keeps its dtype (a wider eps nudge there)
    got32 = upper_gamma(torch.tensor(a, dtype=torch.float32),
                        torch.tensor(x, dtype=torch.float32))
    assert got32.dtype == torch.float32
    far = (np.abs(a - np.round(a)) > 0.05) & (x <= 2.0)
    np.testing.assert_allclose(got32.numpy()[far], want[far], rtol=2e-3)


def test_schechter_forms_match_jax(rng):
    logL = rng.uniform(40.5, 44.0, 60)
    L = 10.0 ** logL
    al = rng.uniform(-3.0, -0.2, 60)
    lstar = rng.uniform(41.5, 43.5, 60)
    phi = rng.uniform(-4.0, -1.5, 60)
    t, j = torch.tensor, jnp.asarray
    for tf, jf, args in (
            (tsch.schechter, jsch.schechter, (L, al, 10.0 ** phi,
                                              10.0 ** lstar)),
            (tsch.schechter_log, jsch.schechter_log, (logL, al, phi, lstar)),
            (tsch.schechter_integ, jsch.schechter_integ,
             (L, al, 10.0 ** phi, 10.0 ** lstar)),
            (tsch.schechter_integ_log, jsch.schechter_integ_log,
             (logL, al, phi, lstar))):
        np.testing.assert_allclose(tf(*map(t, args)).numpy(),
                                   np.asarray(jf(*map(j, args))),
                                   rtol=1e-10, err_msg=tf.__name__)


def _cosmo_pair(zmax=2.2):
    jc = build_cosmo_table(zmax, dtype=jnp.float64)
    tc = cosmo_table_from_arrays(
        {k: np.asarray(getattr(jc, k)) for k in COSMO_FIELDS}, "cpu",
        torch.float64)
    return jc, tc


def test_veff_bin_helpers_match_jax(rng):
    jc, tc = _cosmo_pair()
    lum_lin = 10.0 ** rng.uniform(41.0, 43.5, 300)
    logfmin, zmin, zmax = -16.4, 1.2, 1.9
    np.testing.assert_allclose(
        tveff.linear_bin_edges(torch.tensor(lum_lin), logfmin, zmax, tc,
                               20).numpy(),
        np.asarray(jveff.linear_bin_edges(jnp.asarray(lum_lin), logfmin,
                                          zmax, jc, 20)), rtol=1e-12)
    # bins wholly below the curve (inf), cut by it, and wholly above (1)
    lo = float(logfmin + jveff._LOG10_4PI
               + 2.0 * jc.log10_dl_cm_at(jnp.asarray(zmin)))
    hi = float(logfmin + jveff._LOG10_4PI
               + 2.0 * jc.log10_dl_cm_at(jnp.asarray(zmax)))
    edges = np.linspace(lo - 0.3, hi + 0.4, 12)
    got = [float(tveff.mult_factor(a, b, logfmin, zmin, zmax, tc))
           for a, b in zip(edges[:-1], edges[1:])]
    want = [float(jveff.mult_factor(jnp.asarray(a), jnp.asarray(b), logfmin,
                                    zmin, zmax, jc))
            for a, b in zip(edges[:-1], edges[1:])]
    assert np.isinf(want[0]) and want[-1] == 1.0
    assert sum(1.0 < w < np.inf for w in want) >= 4
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # a minimum flux of 0 (no cut): every bin is whole
    assert float(tveff.mult_factor(41.0, 41.1, -np.inf, zmin, zmax,
                                   tc)) == 1.0
    lf, var = rng.uniform(1e-4, 1e-2, 8), rng.uniform(1e-9, 1e-7, 8)
    e = edges[2:11]
    glf, gvar = tveff.apply_partial_bin_correction(e, lf, var, logfmin,
                                                   zmin, zmax, tc)
    wlf, wvar = jveff.apply_partial_bin_correction(e, lf, var, logfmin,
                                                   zmin, zmax, jc)
    assert (wlf[:3] > lf[:3]).all() and wlf[-1] == lf[-1]
    np.testing.assert_allclose(glf, wlf, rtol=1e-12)
    np.testing.assert_allclose(gvar, wvar, rtol=1e-12)
    z = rng.uniform(1.1, 1.9, 101)
    for nb in (1, 3, 4):
        np.testing.assert_array_equal(tveff.equal_count_z_bins(z, nb),
                                      jveff.equal_count_z_bins(z, nb))


def test_linear_bootstrap_matches_jax_given_the_same_indices(rng):
    """``log_bins=False`` (bins hold sum(phi), no dL division) against
    the JAX estimator's own arithmetic, both fed the same resamples."""
    n, nboot, nbins = 250, 40, 12
    lum = 10.0 ** rng.uniform(41.0, 43.0, n)
    phi = rng.uniform(1e-6, 1e-4, n)
    edges = np.linspace(lum.min() * 1.5, lum.max(), nbins + 1)
    idx = rng.integers(0, n, (nboot, n))
    lavg, lf, var = tveff._binned_lf_bootstrap_idx(
        torch.tensor(lum), torch.tensor(phi), torch.tensor(edges),
        torch.tensor(idx), nbins, log_bins=False)
    bin_idx = np.clip(np.searchsorted(edges, lum, side="right") - 1, 0,
                      nbins - 1)
    contrib = phi * ((lum >= edges[0]) & (lum < edges[-1]))
    want_lf = np.bincount(bin_idx, weights=contrib, minlength=nbins)
    boots = np.stack([np.bincount(bin_idx[i], weights=contrib[i],
                                  minlength=nbins) for i in idx])
    want_var = boots.var(axis=0, ddof=1)
    np.testing.assert_allclose(lavg.numpy(), 0.5 * (edges[:-1] + edges[1:]),
                               rtol=1e-14)
    np.testing.assert_allclose(lf.numpy(), want_lf, rtol=1e-12)
    np.testing.assert_allclose(var.numpy(), want_var, rtol=1e-9)
    # the JAX function on the same data, its own draws: the same binned LF
    _, jlf, _ = jveff.binned_lf_bootstrap(
        jax.random.PRNGKey(0), jnp.asarray(lum), jnp.asarray(phi),
        jnp.asarray(edges), nboot, nbins, log_bins=False)
    np.testing.assert_allclose(lf.numpy(), np.asarray(jlf), rtol=1e-12)


def _binned_lf(log, seed=5, nbins=24):
    """A noisy binned Schechter LF with its variances, in the units the
    parameterization takes."""
    rng = np.random.default_rng(seed)
    logl = np.linspace(41.0, 43.3, nbins)
    truth = np.asarray(jsch.schechter_log(jnp.asarray(logl), -1.6, -2.6,
                                          42.5))
    sd = truth * rng.uniform(0.05, 0.15, nbins)
    y = truth + sd * rng.standard_normal(nbins)
    if log:
        return logl, y, sd ** 2
    lin = 10.0 ** logl
    scale = 3e-3 / y.max()              # dn/d(L/L*)-sized numbers
    return lin, y * scale, (sd * scale) ** 2


@pytest.mark.parametrize("log,integ", FORMS, ids=FORM_IDS)
@pytest.mark.parametrize("alpha_value", [None, -1.6],
                         ids=["free-alpha", "fixed-alpha"])
def test_fit_schechter_matches_jax(log, integ, alpha_value):
    lavg, lf, var = _binned_lf(log)
    got = tfit.fit_schechter(lavg, lf, var, name="OIII", log=log,
                             integ=integ, alpha_value=alpha_value)
    want = jfit.fit_schechter(lavg, lf, var, name="OIII", log=log,
                              integ=integ, alpha_value=alpha_value)
    assert got.success and want.success
    assert got.free_names == want.free_names
    assert (got.log, got.integ, got.alpha_fixed) == (log, integ, alpha_value)
    for nm in want.params:
        np.testing.assert_allclose(got.params[nm], want.params[nm],
                                   rtol=1e-5, err_msg=nm)
    for nm in want.stderr:
        np.testing.assert_allclose(got.stderr[nm], want.stderr[nm],
                                   rtol=1e-3, err_msg=nm)
    np.testing.assert_allclose(got.chisqr, want.chisqr, rtol=1e-6)
    np.testing.assert_allclose(got.redchi, want.redchi, rtol=1e-6)
    np.testing.assert_allclose(got.cov, want.cov, rtol=2e-3,
                               atol=1e-6 * np.abs(want.cov).max())
    np.testing.assert_allclose(got.best_fit(lavg), want.best_fit(lavg),
                               rtol=1e-5)
    np.testing.assert_allclose(got.eval_uncertainty(lavg),
                               want.eval_uncertainty(lavg), rtol=1e-3)
    assert got.fit_report().splitlines()[0] == "[[Schechter fit]]"
    assert ("(fixed)" in got.fit_report()) == (alpha_value is not None)


def test_fit_schechter_alpha_start_follows_the_line():
    lavg, lf, var = _binned_lf(True)
    for name in ("OIII", "Ha"):
        got = tfit.fit_schechter(lavg, lf, var, name=name, log=True,
                                 max_iter=0)
        want = jfit.fit_schechter(lavg, lf, var, name=name, log=True,
                                  max_iter=0)
        assert got.params == want.params and not got.success
        assert got.params["al"] == (-2.461 if name == "OIII" else -1.714)


_FIT_LINE = re.compile(r"^\s+(al|phistar|integ|Lstar)\s+= (\S+) \+/- (\S+)")


def _vmax(main, workdir, argv, capsys):
    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        capsys.readouterr()
        assert main(["vmax"] + argv) == 0
        out = capsys.readouterr().out
    finally:
        os.chdir(cwd)
    files = sorted(os.path.relpath(os.path.join(d, f), workdir)
                   for d, _, fs in os.walk(workdir) for f in fs)
    fits, cur = [], {}
    for line in out.splitlines():
        m = _FIT_LINE.match(line)
        if m:
            cur[m.group(1)] = (float(m.group(2)), float(m.group(3)))
            if m.group(1) == "Lstar":
                fits.append(cur)
                cur = {}
    return files, fits


@pytest.mark.parametrize("extra,sub,nfits", [
    ([], "Log", 1),
    (["--zbins", "3", "--integ", "-o", "zz.png"], "Log", 3),
    (["--correct-low"], "Log", 1),
    (["--linear"], "Lin", 1),
    (["--linear", "--integ"], "Lin", 1),
], ids=["log", "zbins-integ", "correct-low", "linear", "linear-integ"])
def test_vmax_cli_matches_jax_package(tmp_path, capsys, extra, sub, nfits):
    pytest.importorskip("matplotlib")
    argv = ["--synthetic", "1500", "-mcf", "0.5", "-nbins", "20"] + extra
    jfiles, jfits = _vmax(jax_main, str(tmp_path / "jax"), argv, capsys)
    tfiles, tfits = _vmax(port_main, str(tmp_path / "port"),
                          argv + ["--device", "cpu"], capsys)
    assert tfiles == jfiles
    dats = [f for f in tfiles if f.endswith(".dat")]
    assert len(dats) == nfits == len(tfits) == len(jfits)
    assert all(f.startswith(os.path.join("ImageFiles", sub)) for f in tfiles)
    assert len([f for f in tfiles if f.endswith(".png")]) == (
        nfits + (nfits > 1))
    for name in dats:
        jt = read_fixed_width_two_line(str(tmp_path / "jax" / name))
        tt = read_fixed_width_two_line(str(tmp_path / "port" / name))
        assert list(tt) == list(jt) == ["Luminosity", "BinLF", "BinLFErr"]
        np.testing.assert_allclose(tt["Luminosity"], jt["Luminosity"],
                                   rtol=1e-9)
        np.testing.assert_allclose(tt["BinLF"], jt["BinLF"], rtol=1e-9)
        assert (np.asarray(tt["BinLF"]) >= 0).all()
        ratio = np.asarray(tt["BinLFErr"]) / np.asarray(jt["BinLFErr"])
        assert np.isfinite(ratio).all()
        assert abs(np.median(ratio) - 1.0) < 0.35
    for tf, jf in zip(tfits, jfits):
        assert list(tf) == list(jf)
        for nm, (val, err) in jf.items():
            assert abs(tf[nm][0] - val) < err, (nm, tf[nm], jf[nm])


def test_vmax_mcf_scan_and_errors(tmp_path, capsys, monkeypatch):
    pytest.importorskip("matplotlib")
    argv = ["--synthetic", "1500", "-nbins", "15", "--mcf-scan",
            "0.2,0.6,3", "--img-dir", "Scan"]
    jfiles, _ = _vmax(jax_main, str(tmp_path / "jax"), argv, capsys)
    tfiles, _ = _vmax(port_main, str(tmp_path / "port"),
                      argv + ["--device", "cpu"], capsys)
    assert tfiles == jfiles == [
        os.path.join("Scan", "al_ls_mcf_scan_OIII.dat"),
        os.path.join("Scan", "al_ls_mcf_space_mcmc_OIII.png")]
    jt = read_fixed_width_two_line(str(tmp_path / "jax" / tfiles[0]))
    tt = read_fixed_width_two_line(str(tmp_path / "port" / tfiles[0]))
    assert list(tt) == list(jt) == ["mcf", "alpha", "Lstar"]
    np.testing.assert_allclose(tt["mcf"], [0.2, 0.4, 0.6], rtol=1e-12)
    # two bootstrap draws weight the bins differently: the optimum moves
    # by a fraction of its standard error (~0.1 in alpha, ~0.05 in L*)
    np.testing.assert_allclose(tt["alpha"], jt["alpha"], atol=0.15)
    np.testing.assert_allclose(tt["Lstar"], jt["Lstar"], atol=0.08)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="lo,hi,n"):
        port_main(["vmax", "--synthetic", "200", "--mcf-scan", "0.2,0.6",
                   "--device", "cpu"])
    with pytest.raises(SystemExit, match="drop --linear"):
        port_main(["vmax", "--synthetic", "200", "--linear",
                   "--correct-low", "--device", "cpu"])
    with pytest.raises(SystemExit, match="-f FILE or --synthetic"):
        port_main(["vmax", "--device", "cpu"])


def test_vmax_reads_a_catalog_file_and_runs_in_float32(tmp_path, capsys,
                                                       monkeypatch):
    """``-f`` takes the reference's ascii table (``<line>_flux``, ``z``);
    with ``use_x64`` off the log pipeline runs in float32 and ``--linear``
    switches itself to float64."""
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(2)
    flux = 10.0 ** rng.uniform(0.5, 2.0, 900)
    z = rng.uniform(1.2, 1.9, 900)
    with open("cat.dat", "w") as fh:
        fh.write("OIII_flux z\n")
        for f, zz in zip(flux, z):
            fh.write(f"{f:.6f} {zz:.6f}\n")
    with open("f32.json", "w") as fh:
        fh.write('{"use_x64": false}')
    argv = ["vmax", "-f", "cat.dat", "-mcf", "0.5", "-nbins", "12",
            "--device", "cpu"]
    assert port_main(argv + ["--img-dir", "A"]) == 0
    assert port_main(argv + ["--img-dir", "B", "--config", "f32.json"]) == 0
    name = os.path.join("Log", "OIII_Vmax_LF_mcf_50_bins_12_log.dat")
    a = read_fixed_width_two_line(os.path.join("A", name))
    b = read_fixed_width_two_line(os.path.join("B", name))
    np.testing.assert_allclose(b["BinLF"], a["BinLF"], rtol=2e-3, atol=1e-9)
    capsys.readouterr()
    assert port_main(argv + ["--img-dir", "C", "--config", "f32.json",
                             "--linear"]) == 0
    assert "enabling float64" in capsys.readouterr().out
    lin = read_fixed_width_two_line(os.path.join(
        "C", "Lin", "OIII_Vmax_LF_mcf_50_bins_12.dat"))
    assert np.isfinite(lin["BinLF"]).all() and max(lin["Luminosity"]) > 1e41
