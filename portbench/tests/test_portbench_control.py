"""The control: the plain reference in the program's place, computed in
the precision below the one the configuration states (bfloat16 for
``flagship``'s float32), must come out not correct. At the tiny size on
the CPU here; at each cell's own size on the card (marked ``cuda``:
``python -m pytest -m cuda portbench/tests/test_portbench_control.py`` on
a machine with one)."""

import json
import os
import subprocess
import sys

import pytest

from portbench.tests.tiny import REPO, run_tiny, tiny_root

CELLS = ["flagship.stretch"]
# a window of a few whole fits: as many rows compared as a run compares
CARD_SECONDS = 10


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_tiny(root, cell):
    result = run_tiny(root, cell, seed=2 ** 31 + 101,
                      control=True)
    assert result["correct"] is False, result["checks"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at each cell's own "
                    "size runs on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 7, 2 ** 31 + 8, 2 ** 31 + 9])
def test_control_is_not_correct_on_card(card, cell, seed):
    """A run of its own, as the benchmark's runs are, at the cell's size
    with a window of whole fits."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "portbench", "run.py"),
         "--workload", cell, "--seed", str(seed), "--seconds",
         str(CARD_SECONDS), "--trace", "0", "--control"],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    print(cell, seed, result["checks"])
    assert result["correct"] is False, result["checks"]
