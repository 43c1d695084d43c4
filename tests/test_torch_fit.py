"""The ``fit`` and ``fitz`` CLIs of both packages on one synthetic
catalog.

The same command line runs through the JAX package and the PyTorch port
(``--device cpu`` added for the port, whose default is the card): both
write the same artifact files with the same columns, and every posterior
median of the port lies within 0.5 posterior sd of the JAX package's.
The chains differ (the frameworks draw different random numbers) but are
long enough (~700 effective samples) that an honest port sits ~0.1 sd
away. ``--sampler nuts`` is checked against the port's own stretch run
of the same command. ``fitz`` is held to the JAX ``fitz`` the same way
(``LFMCMCzOut/``, the LF matrix columns of ``bestfitLF``), at 800 steps.
"""

import json
import os

import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.cli.main import main as jax_main
from lumfuncmcmc_tpu.config import LFConfig
from lumfuncmcmc_tpu.utils.io import read_fixed_width_two_line
from lumfuncmcmc_tpu_torch.cli.main import main as port_main
from tests.torch_grid_worker import run_grid_flags

torch.set_num_threads(2)
# 64 walkers: over four catalog seeds the largest of the nine median gaps
# was 0.44-0.83 sd at 32 walkers and 0.16-0.31 sd at 64, with the worst
# column changing from seed to seed (chain noise, not a bias)
ARGS = ["--synthetic", "300", "-mcf", "0.5", "-ns", "400", "-nw", "64",
        "--size-ln", "21", "-o", "t.dat"]
BASE = "t_nb50_nw64_ns400_mcf50"



def _no_plot_config(path):
    od = dict(LFConfig().output_dict)
    od["triangle plot"] = False
    with open(path, "w") as fh:
        json.dump({"output_dict": od}, fh)
    return str(path)


def _run(main, workdir, argv, outdir="LFMCMCOut"):
    os.makedirs(workdir)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        assert main(argv) == 0
    finally:
        os.chdir(cwd)
    out = os.path.join(workdir, outdir)
    return out, sorted(os.listdir(out))


def _compare(tmp_path, extra, port_extra=(), command="fit",
             outdir="LFMCMCOut", args=ARGS, base=BASE, max_gap=0.5):
    """Run ``command`` through both CLIs; returns the two output
    directories after the shared checks: the same files with the same
    columns, finite Ln Prob, every median within ``max_gap`` posterior
    sd of the JAX package's."""
    cfg_path = _no_plot_config(tmp_path / "cfg.json")
    argv = [command] + args + extra + ["--config", cfg_path]
    jdir, jfiles = _run(jax_main, str(tmp_path / "jax"), argv, outdir)
    tdir, tfiles = _run(port_main, str(tmp_path / "port"),
                        argv + ["--device", "cpu"] + list(port_extra),
                        outdir)
    assert tfiles == jfiles
    assert f"fitposterior_{base}.dat" in tfiles
    for name in tfiles:
        if name.endswith(".dat"):
            jt = read_fixed_width_two_line(os.path.join(jdir, name))
            tt = read_fixed_width_two_line(os.path.join(tdir, name))
            assert list(tt) == list(jt), name
    jpost = read_fixed_width_two_line(
        os.path.join(jdir, f"fitposterior_{base}.dat"))
    tpost = read_fixed_width_two_line(
        os.path.join(tdir, f"fitposterior_{base}.dat"))
    assert np.isfinite(tpost["Ln Prob"]).all()
    for col in jpost:
        if col == "Ln Prob":
            continue
        sd = np.std(jpost[col])
        gap = abs(np.median(tpost[col]) - np.median(jpost[col])) / sd
        assert gap < max_gap, (col, gap)
    return jdir, tdir


def _same_column(jdir, tdir, name, col):
    np.testing.assert_allclose(
        read_fixed_width_two_line(os.path.join(tdir, name))[col],
        read_fixed_width_two_line(os.path.join(jdir, name))[col],
        rtol=1e-12)


def test_fit_cli_matches_jax_package(tmp_path):
    """Free completeness, the port's eager engine (the CPU default)."""
    jdir, tdir = _compare(tmp_path, [])
    # the bestfitLF luminosities are the same catalog
    _same_column(jdir, tdir, f"bestfitLF_{BASE}.dat", "Luminosity")


def test_fit_fix_comp_cli_through_the_kernel_path(tmp_path):
    """Fixed completeness through ``--use-pallas``: on the CPU that is the
    kernels' plain versions, the same code path the card takes up to the
    kernel launch."""
    jdir, tdir = _compare(tmp_path, ["-fc"], port_extra=["--use-pallas"])
    _same_column(jdir, tdir, f"bestfitLF_{BASE}.dat", "Luminosity")


ZARGS = ["--synthetic", "300", "-mcf", "0.5", "-ns", "800", "-nw", "64",
         "--size-ln", "21", "-o", "t.dat"]
ZBASE = "t_nb50_nw64_ns800_mcf50"


@pytest.mark.parametrize("engine", ["eager", "plain"])
def test_fitz_cli_matches_jax_package(tmp_path, engine):
    """``fitz`` through the eager engine (the CPU default) and through
    ``--use-pallas`` (the z kernels' plain versions): the JAX CLI's file
    names and columns in ``LFMCMCzOut/``, pivot medians within 0.5
    posterior sd, and the same LF-matrix axes."""
    jdir, tdir = _compare(
        tmp_path, [], command="fitz", outdir="LFMCMCzOut", args=ZARGS,
        base=ZBASE,
        port_extra=["--use-pallas"] if engine == "plain" else [])
    name = f"bestfitLF_{ZBASE}.dat"
    cols = list(read_fixed_width_two_line(os.path.join(tdir, name)))
    assert cols == (["Luminosity_cols", "Redshift_rows"]
                    + [f"LF_z{i}" for i in range(100)])
    for col in cols[:2]:
        _same_column(jdir, tdir, name, col)
    post = read_fixed_width_two_line(
        os.path.join(tdir, f"fitposterior_{ZBASE}.dat"))
    assert len(post) == 8 and r"$\log {\rm{L}}2_*$" in post


def test_port_triangle_plot_resume_and_unported_flags(tmp_path,
                                                      monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)
    args = ["fit", "--synthetic", "200", "-mcf", "0.5", "-ns", "40", "-nw",
            "16", "--size-ln", "11", "-o", "p.dat", "--device", "cpu"]
    assert port_main(args) == 0
    png = tmp_path / "LFMCMCOut" / "triangle_p_nb50_nw16_ns40_mcf50.png"
    assert png.exists()
    mtime = png.stat().st_mtime_ns
    # an existing fitposterior: reload and replot, no sampling
    assert port_main(args) == 0
    assert png.stat().st_mtime_ns >= mtime
    # ported: --nuts-pooled is taken (the existing posterior is reloaded)
    assert port_main(args + ["--sampler", "nuts", "--nuts-pooled"]) == 0
    no_plot = ["--config", _no_plot_config(tmp_path / "cfg.json")]
    run_grid_flags(port_main, args, tmp_path / "LFMCMCOut",
                   "nb50_nw16_ns40_mcf50", no_plot)
    # ported: the long-run flags, each a fresh run with its artifacts
    nuts = ["--sampler", "nuts", "-fc", "--nchains", "2", "-ns", "10"]
    for name, flag, ckpt in (
            ("a", ["--min-ess", "100"], None),
            ("b", ["--ensembles", "2", "--checkpoint-every", "20"],
             "checkpoint_ens"),
            ("c", ["--exact-bounds"], None),
            ("d", nuts + ["--min-ess", "5"], None),
            ("e", nuts + ["--checkpoint-every", "5"], "checkpoint_nuts")):
        assert port_main([x.replace("p.dat", f"{name}.dat") for x in args]
                         + flag + no_plot) == 0
        ns = flag[flag.index("-ns") + 1] if "-ns" in flag else "40"
        stem = f"{name}_nb50_nw16_ns{ns}_mcf50"
        for kind in ("fitposterior", "bestfitLF", "VeffLF"):
            assert (tmp_path / "LFMCMCOut" / f"{kind}_{stem}.dat").exists()
        if ckpt:
            assert (tmp_path / "LFMCMCOut" / f"{ckpt}_{stem}.npz").exists()
    # ported: --map and --ic on the resumed posterior, then compare-ic
    assert port_main(args + ["--map", "--ic"]) == 0
    out = tmp_path / "LFMCMCOut"
    for name in ("map_p_nb50_nw16_ns40_mcf50.dat",
                 "ic_p_nb50_nw16_ns40_mcf50.dat"):
        assert (out / name).exists()
    npz = str(out / "ic_pointwise_p_nb50_nw16_ns40_mcf50.npz")
    assert port_main(["compare-ic", npz, npz]) == 0
    with pytest.raises(SystemExit, match="--nchains must be >= 1"):
        # a new output name: an existing fitposterior skips the sampler
        port_main([a.replace("p.dat", "q.dat") for a in args]
                  + ["--nchains", "0"])


NUTS_ARGS = ["--sampler", "nuts", "-fc", "--device", "cpu", "--size-ln",
             "21", "--synthetic", "300", "-ns", "150", "--nchains", "4",
             "-o", "t.dat"]
NUTS_BASE = "t_nb50_nw100_ns150_mcf0"


def test_nuts_cli_matches_the_stretch_run(tmp_path):
    """``fit --sampler nuts`` writes the stretch run's artifact names and
    columns, and its medians lie within 1 posterior sd of the stretch
    run's (same command without ``--sampler nuts``)."""
    cfg_path = _no_plot_config(tmp_path / "cfg.json")
    runs = {}
    for name, argv in (("nuts", NUTS_ARGS),
                       ("stretch", NUTS_ARGS[2:])):
        workdir = str(tmp_path / name)
        os.makedirs(workdir)
        cwd = os.getcwd()
        os.chdir(workdir)
        try:
            assert port_main(["fit"] + argv + ["--config", cfg_path]) == 0
        finally:
            os.chdir(cwd)
        out = os.path.join(workdir, "LFMCMCOut")
        runs[name] = (out, sorted(os.listdir(out)))
    (ndir, nfiles), (sdir, sfiles) = runs["nuts"], runs["stretch"]
    assert nfiles == sfiles
    assert f"fitposterior_{NUTS_BASE}.dat" in nfiles
    for name in nfiles:
        if name.endswith(".dat"):
            assert list(read_fixed_width_two_line(
                os.path.join(ndir, name))) == list(read_fixed_width_two_line(
                    os.path.join(sdir, name))), name
    npost, spost = (read_fixed_width_two_line(
        os.path.join(d, f"fitposterior_{NUTS_BASE}.dat"))
        for d in (ndir, sdir))
    assert len(npost["Ln Prob"]) == 150 * 4
    assert np.isfinite(npost["Ln Prob"]).all()
    for col in spost:
        if col == "Ln Prob":
            continue
        gap = (abs(np.median(npost[col]) - np.median(spost[col]))
               / np.std(spost[col]))
        assert gap < 1.0, (col, gap)


@pytest.mark.parametrize("extra", [["--use-pallas"],
                                   ["-fsa", "--z-param", "natural"]],
                         ids=["pivots-plain-vg", "natural-fsa-eager"])
def test_fitz_nuts_cli_matches_the_stretch_run(tmp_path, extra):
    """``fitz --sampler nuts`` (through the plain value+gradient version
    of the z kernel, and with ``-fsa --z-param natural`` through autograd
    of the eager engine) writes the stretch ``fitz``'s artifact names and
    columns, and its medians lie within 1 posterior sd of the stretch
    run's."""
    cfg_path = _no_plot_config(tmp_path / "cfg.json")
    common = ["--device", "cpu", "--size-ln", "21", "--synthetic", "300",
              "-mcf", "0.5", "-o", "t.dat", "--config", cfg_path] + extra
    ndir, nfiles = _run(port_main, str(tmp_path / "nuts"),
                        ["fitz", "--sampler", "nuts", "-ns", "150",
                         "--nchains", "4"] + common, "LFMCMCzOut")
    sdir, sfiles = _run(port_main, str(tmp_path / "stretch"),
                        ["fitz", "-ns", "600", "-nw", "64"] + common,
                        "LFMCMCzOut")
    nbase, sbase = "t_nb50_nw100_ns150_mcf50", "t_nb50_nw64_ns600_mcf50"
    assert [f.replace(nbase, "") for f in nfiles] == [
        f.replace(sbase, "") for f in sfiles]
    for name in nfiles:
        if name.endswith(".dat"):
            assert list(read_fixed_width_two_line(
                os.path.join(ndir, name))) == list(read_fixed_width_two_line(
                    os.path.join(sdir, name.replace(nbase, sbase)))), name
    npost = read_fixed_width_two_line(
        os.path.join(ndir, f"fitposterior_{nbase}.dat"))
    spost = read_fixed_width_two_line(
        os.path.join(sdir, f"fitposterior_{sbase}.dat"))
    assert len(npost) == (7 if "-fsa" in extra else 8)
    assert len(npost["Ln Prob"]) == 150 * 4
    assert np.isfinite(npost["Ln Prob"]).all()
    for col in spost:
        if col == "Ln Prob":
            continue
        gap = (abs(np.median(npost[col]) - np.median(spost[col]))
               / np.std(spost[col]))
        assert gap < 1.0, (col, gap)


def test_fitz_resume_pivots_and_unported_flags(tmp_path, monkeypatch):
    from lumfuncmcmc_tpu.cli.common import _pivot_z as jax_pivot_z
    from lumfuncmcmc_tpu_torch import LFConfig as PortConfig
    from lumfuncmcmc_tpu_torch.cli.common import _pivot_z
    for fn, line in (("x/OIIIGautamWillNoAGN.dat", "OIII"), (None, "OIII"),
                     ("cat.dat", "Ha"), ("OIIIGautamWillNoAGN.dat", "Ha")):
        got = _pivot_z(PortConfig(line_name=line), fn)
        want = jax_pivot_z(LFConfig(line_name=line), fn)
        assert (got.z1, got.z2, got.z3) == (want.z1, want.z2, want.z3)
    monkeypatch.chdir(tmp_path)
    cfg_path = _no_plot_config(tmp_path / "cfg.json")
    args = ["fitz", "--synthetic", "200", "-mcf", "0.5", "-ns", "30", "-nw",
            "16", "--size-ln", "7", "-o", "p.dat", "--device", "cpu",
            "--config", cfg_path]
    assert port_main(args) == 0
    post = tmp_path / "LFMCMCzOut" / "fitposterior_p_nb50_nw16_ns30_mcf50.dat"
    mtime = post.stat().st_mtime_ns
    # an existing LFMCMCzOut/ fitposterior: reload it, no sampling
    assert port_main(args) == 0
    assert post.stat().st_mtime_ns == mtime
    # ported: --nuts-pooled is taken (the existing posterior is reloaded)
    assert port_main(args + ["--sampler", "nuts", "--nuts-pooled"]) == 0
    assert post.stat().st_mtime_ns == mtime
    run_grid_flags(port_main, args, tmp_path / "LFMCMCzOut",
                   "nb50_nw16_ns30_mcf50")
    # ported: the long-run flags, each a fresh run with its artifacts
    for name, flag in (("a", ["--min-ess", "100"]), ("b", ["--ensembles",
                                                          "2"]),
                       ("c", ["--checkpoint-every", "10"])):
        assert port_main([a.replace("p.dat", f"{name}.dat") for a in args]
                         + flag) == 0
        assert (tmp_path / "LFMCMCzOut"
                / f"fitposterior_{name}_nb50_nw16_ns30_mcf50.dat").exists()
    assert (tmp_path / "LFMCMCzOut"
            / "checkpoint_c_nb50_nw16_ns30_mcf50.npz").exists()
    # ported: the analyses on the resumed posterior, and a fresh --map
    assert port_main(args + ["--ic", "--ppc", "--evidence", "4"]) == 0
    assert post.stat().st_mtime_ns == mtime
    assert port_main([a.replace("p.dat", "q.dat") for a in args]
                     + ["--map"]) == 0
    out = tmp_path / "LFMCMCzOut"
    for name in ("ic_p", "ppc_p", "evidence_p", "map_q"):
        assert (out / f"{name}_nb50_nw16_ns30_mcf50.dat").exists(), name
    # fith is ported: the hierarchical fit runs, into its own directory
    assert port_main(["fith" if a == "fitz" else a.replace("p.dat", "h.dat")
                      for a in args]) == 0
    assert (tmp_path / "LFMCMCHOut"
            / "fitposterior_h_nb50_nw16_ns30_mcf50.dat").exists()
    with pytest.raises(SystemExit):
        port_main(args + ["-sr"])           # fitz has no -sr/--same_rand
