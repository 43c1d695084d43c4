"""The port stands alone: with ``jax`` and ``lumfuncmcmc_tpu`` made
unimportable, every module of ``lumfuncmcmc_tpu_torch`` imports and a
tiny ``--device cpu`` run of each subcommand (``fit``, ``fitz``,
``fith``, ``vmax``) works; without
``--device cpu`` and with no CUDA device, each fails and names
``--device cpu`` instead of running on the CPU.
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
