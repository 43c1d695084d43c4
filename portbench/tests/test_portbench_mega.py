"""The cell ``mega.stretch`` at a tiny size on the CPU: the survey's own
two fields with their areas cut by ``area_scale`` to 151,225 sources (past
``STREAM_MIN_SOURCES``, so the plain versions of the streaming kernels run
in float64), an 11 x 11 grid a field and the tiny mix of ``tiny.py``.

It rehearses correct and gives its metrics; each control
(``controls.py``) and each fault of ``test_portbench_faults.py`` comes out
not correct against the cell's own limits; and running it leaves every
file of the copy and of the repository's ``portbench/`` as it was. The
area is large enough for the float32-rounded lnp to show: |lnp| ~ 2e6,
where a float32 spacing is 0.25 against ``dlnp_gap``'s 0.05.
"""

import hashlib
import json
import os

import pytest

from portbench.tests.controls import KINDS, run_control
from portbench.tests.test_portbench_faults import FAULTS, STEPS
from portbench.tests.tiny import REPO, run_tiny, tiny_root

CELL = "mega.stretch"
AREA_SCALE = 0.22
# the faults' catalog (6,873 sources, on the streaming route all the
# same): a tiny fit of 16 walkers reaches the posterior's bulk, where a
# wrong accept ratio shows, within STEPS steps only at this size
FAULT_AREA_SCALE = 0.01
SIZE_LN = 11


def _digest(root):
    out = {}
    for base, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _edit(root, rel, edit):
    path = os.path.join(root, "portbench", rel)
    with open(path) as fh:
        spec = json.load(fh)
    edit(spec)
    with open(path, "w") as fh:
        json.dump(spec, fh)


def _mega_root(tmp_path_factory, area_scale):
    root = tiny_root(str(tmp_path_factory.mktemp("tiny")))

    def edit(cfg):
        cfg["catalog"]["area_scale"] = area_scale
        cfg["lfconfig"]["size_ln"] = SIZE_LN
    _edit(root, os.path.join("configs", "mega.json"), edit)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _mega_root(tmp_path_factory, AREA_SCALE)


@pytest.fixture(scope="module")
def fault_root(tmp_path_factory):
    """One fit of ``STEPS`` steps fills the window, as in
    ``test_portbench_faults.py``."""
    root = _mega_root(tmp_path_factory, FAULT_AREA_SCALE)
    _edit(root, os.path.join("traffic", "stretch.json"),
          lambda mix: mix.update(nsteps=STEPS))
    return root


def test_tiny_mega_runs_correct_and_leaves_every_file(root):
    before = _digest(root)
    repo_before = _digest(os.path.join(REPO, "portbench"))
    plain = run_tiny(root, CELL, seed=2 ** 31 + 22)
    assert plain["correct"], plain["checks"]
    assert plain["device"]["sources"] == 151_225
    assert plain["device"]["dtype"] == "float64"
    assert set(plain["metrics"]) == {"lnprob_evals_per_s", "setup_s"}
    traced = run_tiny(root, CELL, seed=2 ** 33 + 5, trace=1)
    assert traced["correct"], traced["checks"]
    # no device trace on the CPU: the roofline and the idle share are
    # the card's
    assert {"collapse_us", "features_us", "kernel_host_us", "step_self_us",
            "post_s", "lnprob_call_us", "context_build_s"} <= set(
                traced["metrics"])
    assert traced["metrics"]["collapse_us"]["value"] > 0
    assert _digest(root) == before
    assert _digest(os.path.join(REPO, "portbench")) == repo_before


@pytest.mark.parametrize("kind", KINDS)
def test_control_is_not_correct(root, kind):
    result = run_control(root, CELL, 2 ** 31 + 101, 1.5, kind,
                         device="cpu")
    assert result["correct"] is False, result["checks"]
    if kind == "lnp_float32":
        # the program's own lnp, rounded: every count sound, the lnp
        # differences not
        checks = {k: c["value"] for k, c in result["checks"].items()}
        assert checks["dlnp_gap"] > 0.05
        assert all(checks[k] == 0 for k in checks if k.startswith("bad_"))


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault_root, monkeypatch, fault):
    from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES", 0)
    FAULTS[fault](monkeypatch)
    result = run_tiny(fault_root, CELL, seed=2 ** 32 + 3, seconds=0.1)
    assert result["attempted"] == 1
    assert result["correct"] is False, result["checks"]
