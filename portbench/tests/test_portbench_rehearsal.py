"""A CPU rehearsal of each tiny cell: the whole run but the look for a
card, on the kernels' plain versions. It must come out correct, give the
cell's metrics, and load no module whose top-level name is JAX's or the
JAX package's (checked in a process of its own)."""

import json
import os
import subprocess
import sys

import pytest

from portbench.tests.tiny import REPO, run_tiny, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("cell", ["flagship.stretch"])
def test_tiny_cell_runs_correct(root, cell):
    plain = run_tiny(root, cell, seed=2 ** 31 + 11)
    assert plain["correct"], plain["checks"]
    assert plain["attempted"] > 0 and plain["failed"] == 0
    assert set(plain["metrics"]) == {"lnprob_evals_per_s", "setup_s"}
    assert list(plain)[-1] == "checks"
    traced = run_tiny(root, cell, seed=5, trace=1)
    assert traced["correct"], traced["checks"]
    assert "context_build_s" in traced["metrics"]
    # the lnprob calls are timed in the fit before the traced one
    assert traced["metrics"]["lnprob_call_us"]["value"] > 0
    assert traced["attempted"] >= 2
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert traced["device"]["window_s"] > 0


def test_no_jax_module_loaded(root):
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from portbench.tests.tiny import run_tiny\n"
            "from portbench.harness.runner import forbidden_modules\n"
            "r = run_tiny(%r, 'flagship.stretch', trace=1)\n"
            "print(json.dumps([r['correct'], forbidden_modules(),"
            " sorted(m for m in sys.modules if m.startswith('lumfunc'))[:3]]))"
            % (REPO, root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    correct, bad, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and bad == []
    assert port and all(m.startswith("lumfuncmcmc_tpu_torch") for m in port)


def test_run_without_card_fails(tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "portbench", "run.py"),
         "--workload", "flagship.stretch", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "card" in out.stderr


def test_run_without_program_fails(tmp_path):
    import shutil
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(tmp_path, "portbench"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, os.path.join(tmp_path, "portbench", "run.py"),
         "--workload", "flagship.stretch", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
