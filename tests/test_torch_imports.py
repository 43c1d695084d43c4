"""The port stands alone: with ``jax`` and ``lumfuncmcmc_tpu`` made
unimportable, every module of ``lumfuncmcmc_tpu_torch`` imports and a
tiny ``--device cpu`` fit runs; without ``--device cpu`` and with no
CUDA device, ``fit`` fails and names ``--device cpu`` instead of running
on the CPU.
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

FIT = ["fit", "--synthetic", "120", "-mcf", "0.5", "-ns", "10", "-nw", "8",
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


def test_port_imports_nothing_of_jax_and_runs_a_cpu_fit(tmp_path):
    proc = _run(tmp_path, BLOCKED_RUN, FIT + ["--device", "cpu"], {})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RC 0" in proc.stdout
    assert int(proc.stdout.split("IMPORTED")[1].split()[0]) >= 25
    assert (tmp_path / "LFMCMCOut" / "fitposterior_g_nb50_nw8_ns10_mcf50.dat"
            ).exists()


def test_fit_without_a_card_fails_and_names_device_cpu(tmp_path):
    code = ("import sys; from lumfuncmcmc_tpu_torch.cli.main import main; "
            "sys.exit(main(sys.argv[1:]))")
    proc = _run(tmp_path, code, FIT, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert not (tmp_path / "LFMCMCOut" / "g.dat").exists()
