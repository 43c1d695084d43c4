"""The port stands alone: with ``jax`` and ``lumfuncmcmc_tpu`` made
unimportable, every module of ``lumfuncmcmc_tpu_torch`` imports and a
tiny ``--device cpu`` run of each subcommand (``fit``, ``fitz``,
``fith``, ``vmax``, the model comparison: ``--ic``, ``--ppc``,
``--evidence``, ``--map``, ``--init-map``, ``compare-ic``, ``stack-ic``,
and the long-run drivers: a checkpointed ``--min-ess`` fit and an
``--ensembles`` fit, and the grid: ``fit --mesh-walkers 2`` on two gloo
ranks, with the stretch move and with ``--sampler nuts``) works; without ``--device cpu`` and with no CUDA device, each fit fails
and names ``--device cpu`` instead of running on the CPU, while
``compare-ic`` / ``stack-ic``, which read only ``.npz`` files, run.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED_RUN = r'''
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "lumfuncmcmc_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import lumfuncmcmc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    lumfuncmcmc_tpu_torch.__path__, "lumfuncmcmc_tpu_torch.")
    if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
from lumfuncmcmc_tpu_torch.cli.main import main
rc = main(sys.argv[1:])
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "lumfuncmcmc_tpu")]
assert not bad, bad
print("IMPORTED", len(names), "RC", rc)
'''

FIT = ["--synthetic", "120", "-mcf", "0.5", "-ns", "10",
       "--size-ln", "7", "-o", "g.dat"]


def _run(tmp_path, code, argv, env_extra):
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"output_dict": {"parameters": true, "settings": true,'
                   ' "fitposterior": true, "bestfitLF": true, "VeffLF": '
                   'true, "triangle plot": false, "image format": "png"}}')
    env = dict(os.environ, PYTHONPATH=REPO, **env_extra)
    return subprocess.run(
        [sys.executable, "-c", code, *argv, "--config", str(cfg)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def _blocked_fit(tmp_path, command, outdir, nw):
    proc = _run(tmp_path, BLOCKED_RUN,
                [command] + FIT + ["-nw", str(nw), "--device", "cpu"], {})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RC 0" in proc.stdout
    assert int(proc.stdout.split("IMPORTED")[1].split()[0]) >= 26
    assert (tmp_path / outdir / f"fitposterior_g_nb50_nw{nw}_ns10_mcf50.dat"
            ).exists()


def _fit_without_a_card(tmp_path, command, outdir, nw):
    code = ("import sys; from lumfuncmcmc_tpu_torch.cli.main import main; "
            "sys.exit(main(sys.argv[1:]))")
    proc = _run(tmp_path, code, [command] + FIT + ["-nw", str(nw)],
                {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert not (tmp_path / outdir / "g.dat").exists()


def test_port_imports_nothing_of_jax_and_runs_a_cpu_fit(tmp_path):
    _blocked_fit(tmp_path, "fit", "LFMCMCOut", 8)


def test_port_imports_nothing_of_jax_and_runs_a_cpu_fitz(tmp_path):
    _blocked_fit(tmp_path, "fitz", "LFMCMCzOut", 16)


def test_port_imports_nothing_of_jax_and_runs_a_cpu_fith(tmp_path):
    _blocked_fit(tmp_path, "fith", "LFMCMCHOut", 32)


VMAX = ["vmax", "--synthetic", "400", "-mcf", "0.5", "-nbins", "8"]
VMAX_DAT = os.path.join("ImageFiles", "Log",
                        "OIII_Vmax_LF_mcf_50_bins_8_log.dat")


def test_port_imports_nothing_of_jax_and_runs_a_cpu_vmax(tmp_path):
    proc = _run(tmp_path, BLOCKED_RUN, VMAX + ["--device", "cpu"], {})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RC 0" in proc.stdout and "[[Schechter fit]]" in proc.stdout
    assert int(proc.stdout.split("IMPORTED")[1].split()[0]) >= 31
    assert (tmp_path / VMAX_DAT).exists()


def test_vmax_without_a_card_fails_and_names_device_cpu(tmp_path):
    code = ("import sys; from lumfuncmcmc_tpu_torch.cli.main import main; "
            "sys.exit(main(sys.argv[1:]))")
    proc = _run(tmp_path, code, VMAX, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert not (tmp_path / VMAX_DAT).exists()


def test_fit_without_a_card_fails_and_names_device_cpu(tmp_path):
    _fit_without_a_card(tmp_path, "fit", "LFMCMCOut", 8)


def test_fitz_without_a_card_fails_and_names_device_cpu(tmp_path):
    _fit_without_a_card(tmp_path, "fitz", "LFMCMCzOut", 16)


def test_fith_without_a_card_fails_and_names_device_cpu(tmp_path):
    _fit_without_a_card(tmp_path, "fith", "LFMCMCHOut", 32)


def test_port_imports_nothing_of_jax_and_runs_a_cpu_stream_fit(tmp_path):
    """The streaming path (gate lowered) and the roofline module with
    jax blocked: the fit logs the streaming engine."""
    code = BLOCKED_RUN.replace(
        "from lumfuncmcmc_tpu_torch.cli.main import main\n",
        "from lumfuncmcmc_tpu_torch.cli.main import main\n"
        "from lumfuncmcmc_tpu_torch.ops import cuda_lnlike, roofline\n"
        "import torch\n"
        "cuda_lnlike.STREAM_MIN_SOURCES = 0\n"
        "assert roofline.roofline_chain(torch.full((4,), 0.5), 3).shape "
        "== (4,)\n")
    proc = _run(tmp_path, code, ["fit"] + FIT + ["-nw", "8", "--device",
                                                 "cpu", "--use-pallas"], {})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RC 0" in proc.stdout
    assert "plain versions of the streaming kernels" in (proc.stdout
                                                         + proc.stderr)
    assert (tmp_path / "LFMCMCOut" / "fitposterior_g_nb50_nw8_ns10_mcf50.dat"
            ).exists()


COMPARISON = r"""
from lumfuncmcmc_tpu_torch.cli.main import main as _main
_cfg = sys.argv[-2:]
_fit = ["--synthetic", "120", "-mcf", "0.5", "-ns", "10", "-nw", "8",
        "--size-ln", "7", "--device", "cpu"] + _cfg
assert _main(["fit", "-o", "a.dat", "--ic", "--ppc", "--evidence", "3",
              "--evidence-swap", "2", "--evidence-tune", "1"] + _fit) == 0
assert _main(["fit", "-fc", "-o", "b.dat", "--ic", "--map"] + _fit) == 0
assert _main(["fit", "-fc", "-o", "b.dat", "--ic"] + _fit) == 0
assert _main(["fitz", "-o", "c.dat", "--init-map"] + _fit) == 0
_npz = ["LFMCMCOut/ic_pointwise_%s_nb50_nw8_ns10_mcf50.npz" % o
        for o in "ab"]
assert _main(["compare-ic"] + _npz) == 0
sys.argv[1:] = ["stack-ic"] + _npz
"""


def test_port_imports_nothing_of_jax_and_runs_the_model_comparison(
        tmp_path):
    code = BLOCKED_RUN.replace(
        "from lumfuncmcmc_tpu_torch.cli.main import main\n",
        "from lumfuncmcmc_tpu_torch.cli.main import main\n" + COMPARISON)
    proc = _run(tmp_path, code, [], {})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RC 0" in proc.stdout and "stacked log score" in proc.stdout
    out = tmp_path / "LFMCMCOut"
    for name in ("ic_a", "ppc_a", "evidence_a", "map_b", "ic_b"):
        assert (out / f"{name}_nb50_nw8_ns10_mcf50.dat").exists(), name
    assert (tmp_path / "LFMCMCzOut"
            / "fitposterior_c_nb50_nw8_ns10_mcf50.dat").exists()


def test_ic_commands_need_no_card(tmp_path):
    import numpy as np
    rng = np.random.default_rng(0)
    for name in ("a", "b"):
        np.savez(tmp_path / f"{name}.npz", elpd_loo_i=rng.normal(size=50),
                 elpd_waic_i=rng.normal(size=50),
                 pareto_k=rng.uniform(size=50))
    code = ("import sys; from lumfuncmcmc_tpu_torch.cli.main import main; "
            "main(['compare-ic', 'a.npz', 'b.npz']); "
            "sys.exit(main(['stack-ic', 'a.npz', 'b.npz']))")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "paired sources" in proc.stdout
    assert "stacked log score" in proc.stdout


LONGRUN = r"""
from lumfuncmcmc_tpu_torch.cli.main import main as _main
_fit = ["--synthetic", "120", "-mcf", "0.5", "-ns", "10", "-nw", "8",
        "--size-ln", "7", "--device", "cpu"] + sys.argv[-2:]
assert _main(["fit", "-o", "a.dat", "--min-ess", "20",
              "--checkpoint-every", "5"] + _fit) == 0
sys.argv[1:] = ["fit", "-o", "b.dat", "--ensembles", "2"] + _fit
"""


def test_port_imports_nothing_of_jax_and_runs_the_long_run_drivers(
        tmp_path):
    code = BLOCKED_RUN.replace(
        "from lumfuncmcmc_tpu_torch.cli.main import main\n",
        "from lumfuncmcmc_tpu_torch.cli.main import main\n" + LONGRUN)
    proc = _run(tmp_path, code, [], {})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RC 0" in proc.stdout
    out = tmp_path / "LFMCMCOut"
    for name in ("fitposterior_a_nb50_nw8_ns10_mcf50.dat",
                 "checkpoint_until_a_nb50_nw8_ns10_mcf50.npz",
                 "fitposterior_b_nb50_nw8_ns10_mcf50.dat"):
        assert (out / name).exists(), name
    assert "cross-ensemble R-hat" in proc.stderr


def _two_gloo_ranks(tmp_path, code, extra):
    """``fit`` with ``extra`` on two gloo ranks (``--distributed``) with
    ``code`` as the program: both exit 0, rank 0 alone writes. Returns
    the ranks' standard errors."""
    from tests.torch_grid_worker import _free_port
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"output_dict": {"parameters": true, "settings": true,'
                   ' "fitposterior": true, "bestfitLF": true, "VeffLF": '
                   'true, "triangle plot": false, "image format": "png"}}')
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = []
    for r in range(2):
        (tmp_path / f"r{r}").mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, "fit"] + FIT
            + ["-nw", "8", "--device", "cpu", "--mesh-walkers", "2",
               "--distributed", f"127.0.0.1:{port},2,{r}", "--config",
               str(cfg)] + extra, cwd=tmp_path / f"r{r}", env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "RC 0" in out
    assert (tmp_path / "r0" / "LFMCMCOut"
            / "fitposterior_g_nb50_nw8_ns10_mcf50.dat").exists()
    assert not (tmp_path / "r1" / "LFMCMCOut").exists()
    return [err for _, err in outs]


def test_grid_imports_nothing_of_jax_and_runs_on_two_gloo_ranks(tmp_path):
    """The grid twin: with ``jax`` and ``lumfuncmcmc_tpu`` blocked, the
    ``parallel/`` modules import, and ``fit --mesh-walkers 2`` runs on two
    gloo ranks (``--distributed``), rank 0 alone writing."""
    code = BLOCKED_RUN.replace(
        "for name in names:\n",
        "assert {'lumfuncmcmc_tpu_torch.parallel.distributed',\n"
        "        'lumfuncmcmc_tpu_torch.parallel.mesh',\n"
        "        'lumfuncmcmc_tpu_torch.parallel.sharding'} <= set(names)\n"
        "for name in names:\n")
    errs = _two_gloo_ranks(tmp_path, code, [])
    assert "Device grid: {'walkers': 2, 'sources': 1}" in errs[1]


def test_grid_nuts_imports_nothing_of_jax_and_runs_on_two_gloo_ranks(
        tmp_path):
    """The NUTS grid twin: with ``jax`` and ``lumfuncmcmc_tpu`` blocked,
    ``fit --sampler nuts --nuts-pooled --use-pallas --mesh-walkers 2``
    runs on two gloo ranks (the per-rank replicas, pooled; a shallow tree
    keeps it short), rank 0 alone writing."""
    code = BLOCKED_RUN.replace(
        "from lumfuncmcmc_tpu_torch.cli.main import main\n",
        "from lumfuncmcmc_tpu_torch.cli.main import main\n"
        "from lumfuncmcmc_tpu_torch.models import nuts_driver\n"
        "nuts_driver.MAX_DOUBLINGS = 2\n")
    errs = _two_gloo_ranks(tmp_path, code, [
        "--sampler", "nuts", "--nuts-pooled", "--use-pallas", "--nchains",
        "4"])
    for err in errs:
        assert "per-rank replicas over the 2-rank grid" in err
        assert "pooled adaptation" in err
