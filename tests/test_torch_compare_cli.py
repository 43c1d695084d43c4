"""The model-comparison CLI of both packages on one synthetic catalog:
``fit --ic --ppc --evidence 4``, ``fit -fc --ic``, ``fit -fc --map``, a
resumed rerun that adds ``--ic``, then ``compare-ic`` and ``stack-ic`` on
the port's own ``ic_pointwise`` files.

Checked: the same artifact file names as the JAX CLI on the same
arguments (``--device cpu`` added for the port), the same ``map_*.dat``
columns with the optimum within 1e-4 (``tests/test_torch_mapfit.py``),
and the same printed verdict as JAX's ``cmd_compare_ic`` /
``cmd_stack_ic`` on the same ``.npz`` files (stacking weights to the
4 printed decimals). ``fitz`` and ``fith`` are in
``tests/test_torch_compare_cli_zh.py``.
"""

import os
import types

import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.cli import ic_cmds as jcmds
from lumfuncmcmc_tpu.cli.main import main as jax_main
from lumfuncmcmc_tpu.utils.io import read_fixed_width_two_line
from lumfuncmcmc_tpu_torch.cli.main import main as port_main

torch.set_num_threads(2)
ARGS = ["--synthetic", "200", "-mcf", "0.5", "-ns", "60", "-nw", "16",
        "--size-ln", "11"]
CFG = ('{"output_dict": {"triangle plot": false, "fitposterior": true, '
       '"bestfitLF": true, "VeffLF": true, "parameters": true, '
       '"settings": true, "image format": "png"}}')


def run_both(tmp_path, argv, outdir="LFMCMCOut"):
    """``argv`` through both CLIs, each in a directory of its own;
    returns the two output directories, after the check that they hold
    the same file names."""
    dirs = []
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        work = tmp_path / name
        work.mkdir(exist_ok=True)
        (work / "cfg.json").write_text(CFG)
        cwd = os.getcwd()
        os.chdir(work)
        try:
            assert main(argv + ["--config", "cfg.json"] + extra) == 0
        finally:
            os.chdir(cwd)
        dirs.append(work / outdir)
    jfiles, tfiles = (sorted(os.listdir(d)) for d in dirs)
    assert tfiles == jfiles
    return dirs


def _port(tmp_path, argv):
    cwd = os.getcwd()
    os.chdir(tmp_path / "port")
    try:
        assert port_main(argv + ["--config", "cfg.json", "--device",
                                 "cpu"]) == 0
    finally:
        os.chdir(cwd)


def test_fit_analyses_resume_and_ic_commands_match_jax(tmp_path, capsys):
    base = "nb50_nw16_ns60_mcf50"
    jdir, tdir = run_both(tmp_path, ["fit"] + ARGS + [
        "-o", "a.dat", "--ic", "--ppc", "--evidence", "4"])
    for kind, ext in (("ic", "dat"), ("ic_pointwise", "npz"), ("ppc", "dat"),
                      ("evidence", "dat")):
        assert f"{kind}_a_{base}.{ext}" in os.listdir(tdir)
    for kind in ("ic", "ppc", "evidence"):
        name = f"{kind}_a_{base}.dat"
        assert (list(read_fixed_width_two_line(str(tdir / name)))
                == list(read_fixed_width_two_line(str(jdir / name))))
    # a finished fit rerun with --ic: the posterior is kept, the IC added
    _port(tmp_path, ["fit", "-fc"] + ARGS + ["-o", "b.dat"])
    post = tdir / f"fitposterior_b_{base}.dat"
    mtime = post.stat().st_mtime_ns
    assert not (tdir / f"ic_b_{base}.dat").exists()
    _port(tmp_path, ["fit", "-fc"] + ARGS + ["-o", "b.dat", "--ic"])
    assert post.stat().st_mtime_ns == mtime
    assert (tdir / f"ic_pointwise_b_{base}.npz").exists()
    capsys.readouterr()
    npz = [str(tdir / f"ic_pointwise_{o}_{base}.npz") for o in "ab"]
    for port_cmd, jax_cmd, ns in (
            ("compare-ic", jcmds.cmd_compare_ic,
             types.SimpleNamespace(npz_a=npz[0], npz_b=npz[1])),
            ("stack-ic", jcmds.cmd_stack_ic,
             types.SimpleNamespace(npz=npz))):
        assert port_main([port_cmd] + npz) == 0
        got = capsys.readouterr().out
        assert jax_cmd(ns) == 0
        want = capsys.readouterr().out
        assert got == want, (got, want)


def test_map_matches_jax(tmp_path):
    jdir, tdir = run_both(tmp_path, ["fit", "-fc"] + ARGS + ["-o", "m.dat",
                                                               "--map"])
    name = "map_m_nb50_nw16_ns60_mcf50.dat"
    assert name in os.listdir(tdir)
    assert not any(f.startswith("fitposterior") for f in os.listdir(tdir))
    got = read_fixed_width_two_line(str(tdir / name))
    want = read_fixed_width_two_line(str(jdir / name))
    assert list(got) == list(want)
    for col in ("Lstar", "phistar", "sch_al"):
        np.testing.assert_allclose(got[col], want[col], atol=1e-4)
    np.testing.assert_allclose(got["lnpost"], want["lnpost"], atol=1e-6)
    np.testing.assert_allclose(got["lnz_laplace"], want["lnz_laplace"],
                               atol=1e-3)
    with pytest.raises(SystemExit):
        port_main(["fit"] + ARGS + ["--evidence-tune", "1", "--device",
                                    "cpu"])
