"""The port's examples (``lumfuncmcmc_tpu_torch/examples/``): each
script's ``run`` on the CPU at tiny sizes prints its table, each ``main``
passes its command line on, a run without ``--device cpu`` and without a
card fails and names the way out, and the calibration module and every
example import and run with ``jax`` and ``lumfuncmcmc_tpu`` made
unimportable."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu_torch.examples import (
    coverage_check, coverage_check_z, model_comparison, quickstart,
    sbc_check)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_target=150, nwalkers=20, nsteps=30, pad=64, device="cpu")


def test_sbc_check_prints_rank_histograms(capsys):
    ranks = sbc_check.run(2, nwalkers=16, nsteps=40, size_ln=11,
                          device="cpu")
    out = capsys.readouterr().out
    assert ranks.shape == (2, 3) and ((0 <= ranks) & (ranks <= 7)).all()
    assert "2 replicates in" in out and "s per replicate" in out
    assert "rank histograms over {0..7} (expected 0.2 per bin):" in out
    for nm in ("Lstar", "phistar", "sch_al"):
        assert re.search(rf"  {nm}\s+\[[\d ]+\]  chi2=[\d.]+ \(dof 7\)", out)


@pytest.mark.parametrize("free,pallas,move,init_map", [
    (False, None, "stretch", False), (True, True, "mix", False),
    (False, None, "stretch", True)])
def test_coverage_check_prints_coverage(capsys, free, pallas, move,
                                        init_map):
    hits68, hits95 = coverage_check.run(2, free=free, pallas=pallas,
                                        move=move, init_map=init_map,
                                        **TINY)
    out = capsys.readouterr().out
    names = ["Lstar", "phistar", "sch_al"] + (
        [f"Flim_{i}" for i in range(5)] + ["alpha"] if free else [])
    assert list(hits68) == names and list(hits95) == names
    assert "=== coverage over 2 replicates (" in out
    for p in names:
        assert re.search(rf"  {p}\s*: 68% interval covers [\d.]+ \(nominal "
                         rf"0.68 \+- 0.33\); 95% covers [\d.]+", out)
        assert 0 <= hits68[p] <= hits95[p] <= 2


@pytest.mark.parametrize("natural", [False, True])
def test_coverage_check_z_prints_coverage(capsys, natural):
    hits68, _ = coverage_check_z.run(1, natural=natural, n_target=150,
                                     nwalkers=16, nsteps=30, pad=64,
                                     device="cpu")
    out = capsys.readouterr().out
    names = (["Lmid", "Lslope", "Lcurv", "pmid", "pslope", "pcurv"]
             if natural else ["L1", "L2", "L3", "phi1", "phi2", "phi3"])
    assert list(hits68) == names + ["sch_al"]
    assert "=== z-model coverage over 1 replicates (" in out
    assert re.search(r"  pcurv\s*: 68% covers" if natural
                     else r"  phi3\s*: 68% covers", out)


def test_quickstart_tour(capsys, tmp_path):
    model = quickstart.run(n_target=300, nwalkers=16, nsteps=40,
                           nuts_warmup=20, nchains=2, nensembles=2,
                           nrungs=4, evidence_steps=30, ndraws=50,
                           size_ln=11, outdir=str(tmp_path / "qs"),
                           device="cpu")
    out = capsys.readouterr().out
    assert model.device.type == "cpu" and model.samples is not None
    for line in ("synthetic catalog: ", "  stretch  logL*", "  NUTS     alpha",
                 "  cross-ensemble R-hat:", "  ln Z = ", "  elpd_waic = ",
                 "[[Schechter fit]]"):
        assert line in out, line
    try:
        import matplotlib  # noqa: F401
        assert (tmp_path / "qs" / "triangle_quickstart.png").exists()
    except ImportError:
        assert "triangle plot skipped" in out


def test_model_comparison_walkthrough(capsys):
    bf = model_comparison.run(n_target=300, nwalkers=16, nsteps=50,
                              ndraws=50, nrungs=4, evidence_steps=40,
                              swap_every=5, tune_rounds=1, size_ln=11,
                              device="cpu")
    out = capsys.readouterr().out
    assert np.isfinite(bf)
    for head in ("=== 1. MAP + Laplace", "=== 2. fit + WAIC", "=== 3. paired",
                 "=== 4. tempered evidence", "  stacking weights: single=",
                 "  ln Bayes factor (single vs z) = "):
        assert head in out, head
    assert out.count("Laplace lnZ=") == 2 and out.count(" ln Z = ") == 2


@pytest.mark.parametrize("mod,argv,want", [
    (sbc_check, ["3", "--device", "cpu"], ((3,), {"device": "cpu"})),
    (sbc_check, [], ((48,), {"device": None})),
    (coverage_check, ["5", "--free", "--pallas", "--mix", "--device", "cpu"],
     ((5,), {"free": True, "pallas": True, "move": "mix",
             "init_map": False, "device": "cpu"})),
    (coverage_check, ["--init-map"],
     ((40,), {"free": False, "pallas": None, "move": "stretch",
              "init_map": True, "device": None})),
    (coverage_check_z, ["4", "--natural"],
     ((4,), {"natural": True, "device": None})),
    (coverage_check_z, [], ((30,), {"natural": False, "device": None})),
    (quickstart, ["--device", "cpu"], ((), {"device": "cpu"})),
    (model_comparison, [], ((), {"device": None}))])
def test_main_passes_the_command_line_on(monkeypatch, mod, argv, want):
    seen = []
    monkeypatch.setattr(mod, "run", lambda *a, **kw: seen.append((a, kw)))
    assert mod.main(argv) == 0
    assert seen == [want]


def test_example_without_a_card_names_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        sbc_check.run(1, nwalkers=8, nsteps=10, size_ln=11)


BLOCKED = r'''
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "lumfuncmcmc_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(2)
import lumfuncmcmc_tpu_torch.examples as ex
importlib.import_module("lumfuncmcmc_tpu_torch.utils.calibration")
names = [m.name for m in pkgutil.iter_modules(ex.__path__)]
for name in names:
    importlib.import_module("lumfuncmcmc_tpu_torch.examples." + name)
from lumfuncmcmc_tpu_torch.examples import sbc_check
sbc_check.run(1, nwalkers=8, nsteps=30, size_ln=11, device="cpu")
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "lumfuncmcmc_tpu")]
assert not bad, bad
print("EXAMPLES", sorted(names))
'''


def test_calibration_and_examples_import_no_jax(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert ("EXAMPLES ['coverage_check', 'coverage_check_z', "
            "'model_comparison', 'quickstart', 'sbc_check']") in proc.stdout
    assert "rank histograms" in proc.stdout
