"""The ``fith`` CLI of both packages on one synthetic catalog: the
stretch move, the resume-and-replot behaviour (``--nuts-pooled`` taken),
and the long-run flags (``-fsa``, ``--move mix`` and ``--sampler nuts`` are
in ``tests/test_torch_hier_nuts.py``, which shares this file's helpers).

The same command line runs through the JAX package and the PyTorch port
(``--device cpu`` added for the port, whose default is the card): both
write the same artifact files with the same columns under
``LFMCMCHOut/``, and every posterior median of the port lies within 0.5
posterior sd of the JAX package's. The 15-dim posterior (a funnel in
``sig_L``, ``sig_p``) mixes slowly under the stretch move, so the runs
are long: 64 walkers x 4000 stretch steps (largest of the 15 median gaps
over the catalog seeds 1, 2, 3 and 42: 0.09, 0.12, 0.23, 0.19 sd; at
1000 steps 1.65 sd) and, with ``-fsa``, 2000 steps of ``--move mix``
through the kernels' plain versions (seeds 2 and 42: 0.20, 0.15 sd).
``--sampler nuts`` is held to the port's own stretch run of the same
catalog at 1 sd (rehearsed: 0.15-0.16 sd).
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
COMMON = ["--synthetic", "300", "-mcf", "0.5", "--size-ln", "21", "-o",
          "t.dat"]


def _config(tmp_path):
    od = dict(LFConfig().output_dict)
    od["triangle plot"] = False
    path = tmp_path / "cfg.json"
    with open(path, "w") as fh:
        json.dump({"output_dict": od}, fh)
    return ["--config", str(path)]


def _run(main, workdir, argv):
    os.makedirs(workdir)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        assert main(argv) == 0
    finally:
        os.chdir(cwd)
    out = os.path.join(workdir, "LFMCMCHOut")
    return out, sorted(os.listdir(out))


def _posterior(out, base):
    return read_fixed_width_two_line(
        os.path.join(out, f"fitposterior_{base}.dat"))


def _medians_close(got, want, max_gap):
    assert list(got) == list(want)
    assert np.isfinite(got["Ln Prob"]).all()
    for col in want:
        if col != "Ln Prob":
            gap = (abs(np.median(got[col]) - np.median(want[col]))
                   / np.std(want[col]))
            assert gap < max_gap, (col, gap)


def _same_files_and_columns(jdir, jfiles, tdir, tfiles):
    assert tfiles == jfiles
    for name in tfiles:
        if name.endswith(".dat"):
            assert list(read_fixed_width_two_line(
                os.path.join(tdir, name))) == list(
                    read_fixed_width_two_line(os.path.join(jdir, name))), name


def test_fith_cli_matches_jax_package(tmp_path):
    """The stretch move through the port's eager engine (the CPU
    default): 15 parameters plus Ln Prob."""
    argv = (["fith"] + COMMON + ["-ns", "4000", "-nw", "64"]
            + _config(tmp_path))
    base = "t_nb50_nw64_ns4000_mcf50"
    jdir, jfiles = _run(jax_main, str(tmp_path / "jax"), argv)
    tdir, tfiles = _run(port_main, str(tmp_path / "port"),
                        argv + ["--device", "cpu"])
    _same_files_and_columns(jdir, jfiles, tdir, tfiles)
    assert tfiles == sorted(
        [f"{kind}_{base}.dat" for kind in ("fitposterior", "bestfitLF",
                                           "VeffLF")]
        + ["t.dat", "t.dat.args"])
    tpost = _posterior(tdir, base)
    assert len(tpost) == 16 and list(tpost)[:5] == [
        r"$\mu_{L_*}$", r"$\sigma_{L_*}$", r"$\mu_{\phi_*}$",
        r"$\sigma_{\phi_*}$", r"$\alpha$"]
    _medians_close(tpost, _posterior(jdir, base), 0.5)
    lf = f"bestfitLF_{base}.dat"
    np.testing.assert_allclose(
        read_fixed_width_two_line(os.path.join(tdir, lf))["Luminosity"],
        read_fixed_width_two_line(os.path.join(jdir, lf))["Luminosity"],
        rtol=1e-12)


def test_fith_resume_and_unported_flags(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)
    args = ["fith", "--synthetic", "200", "-mcf", "0.5", "-ns", "30", "-nw",
            "32", "--size-ln", "7", "-o", "p.dat", "--device", "cpu"]
    assert port_main(args) == 0
    out = tmp_path / "LFMCMCHOut"
    post = out / "fitposterior_p_nb50_nw32_ns30_mcf50.dat"
    png = out / "triangle_p_nb50_nw32_ns30_mcf50.png"
    assert png.exists()
    mtime = post.stat().st_mtime_ns
    # an existing LFMCMCHOut/ fitposterior: reload it and replot
    assert port_main(args) == 0
    assert post.stat().st_mtime_ns == mtime
    # ported: --nuts-pooled is taken (the existing posterior is reloaded)
    assert port_main(args + ["--sampler", "nuts", "--nuts-pooled"]) == 0
    assert post.stat().st_mtime_ns == mtime
    run_grid_flags(port_main, args, out, "nb50_nw32_ns30_mcf50",
                   _config(tmp_path))
    # ported: the long-run flags, each a fresh run with its artifacts
    for name, flag in (("a", ["--min-ess", "100"]), ("b", ["--ensembles",
                                                          "2"]),
                       ("c", ["--checkpoint-every", "10"])):
        assert port_main([a.replace("p.dat", f"{name}.dat") for a in args]
                         + flag + _config(tmp_path)) == 0
        assert (out / f"fitposterior_{name}_nb50_nw32_ns30_mcf50.dat"
                ).exists()
    assert (out / "checkpoint_c_nb50_nw32_ns30_mcf50.npz").exists()
    # ported: the analyses on the resumed posterior, --map, --init-map
    assert port_main(args + ["--map", "--ic", "--ppc", "--evidence",
                             "4"]) == 0
    assert post.stat().st_mtime_ns == mtime
    assert port_main([a.replace("p.dat", "q.dat") for a in args]
                     + ["--init-map"] + _config(tmp_path)) == 0
    for name in ("map_p", "ic_p", "ppc_p", "evidence_p", "fitposterior_q"):
        assert (out / f"{name}_nb50_nw32_ns30_mcf50.dat").exists(), name
    with pytest.raises(SystemExit):
        port_main(args + ["-sr"])           # fith has no -sr/--same_rand
