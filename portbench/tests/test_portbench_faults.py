"""Each fault a cell can have, planted under the timed path of a run
(everything but the look for a card), makes ``correct`` come out false
against the cell's own limits: a step that returns its state unchanged,
half of the batch left out with the mean of the rest in its place, an
answer altered where it is produced, a step that accepts every proposal,
and a step whose accept ratio takes ``D ln z`` for ``(D - 1) ln z``. (One
card: no exchange between chips to leave out.) At the tiny size on the
CPU here; the two faults of the accept step also at the cell's own size
on the card (marked ``cuda``)."""

import json
import os
import time

import pytest
import torch

from portbench.tests.tiny import REPO, run_tiny, tiny_root

# one tiny fit of this many steps fills the window: the same decisions
# on every run, however loaded the host
STEPS = 400


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_root(str(tmp_path_factory.mktemp("tiny")))
    path = os.path.join(root, "portbench", "traffic", "stretch.json")
    with open(path) as fh:
        mix = json.load(fh)
    mix["nsteps"] = STEPS
    with open(path, "w") as fh:
        json.dump(mix, fh)
    return root


def _like(broken, fn):
    """``broken`` carrying ``fn``'s route attributes, which the program's
    fit routines read."""
    for k in ("data", "engine", "stream"):
        if hasattr(fn, k):
            setattr(broken, k, getattr(fn, k))
    return broken


def _half(fn):
    """``fn`` on the first half of the rows; the rest get its mean."""
    def broken(theta):
        n = max(1, theta.shape[0] // 2)
        head = fn(theta[:n])
        rest = head.mean().expand(theta.shape[0] - n)
        return torch.cat([head, rest])
    return _like(broken, fn)


def _altered(fn):
    """``fn`` with row 0's value raised by 1 + 1e-3 |lnp|."""
    def broken(theta):
        out = fn(theta)
        bump = torch.zeros_like(out)
        bump[0] = 1.0 + 1e-3 * out[0].detach().abs()
        return out + bump
    return _like(broken, fn)


def _patch_lnprob(monkeypatch, wrap):
    from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
    orig = LumFuncModel.lnprob_batch

    def lnprob_batch(self):
        if not getattr(self, "_broken", False):
            self._lnprob_batch = wrap(orig(self))
            self._broken = True
        return self._lnprob_batch
    monkeypatch.setattr(LumFuncModel, "lnprob_batch", lnprob_batch)


def _stuck(monkeypatch):
    from lumfuncmcmc_tpu_torch.samplers import affine
    orig = affine._step_pre

    def step(rands, state, lnprob_batch, a):
        _, acc = orig(rands, state, lnprob_batch, a)
        return state, torch.zeros_like(acc)
    monkeypatch.setattr(affine, "_step_pre", step)


def _accept_step(monkeypatch, ratio):
    """The half-step with its accept test replaced: take the proposal
    where ``ratio(ln z, lnp', lnp, D)`` exceeds ``ln u``."""
    from lumfuncmcmc_tpu_torch.samplers import affine

    def half_step(rand, move_pos, move_lnp, other_pos, lnprob_batch, a,
                  ndim):
        u_z, j, ln_u = rand
        z = ((a - 1.0) * u_z + 1.0) ** 2 / a
        partner = affine._pick(other_pos, j)
        prop = partner + z[..., None] * (move_pos - partner)
        lnp_prop = lnprob_batch(prop)
        accept = ln_u < ratio(torch.log(z), lnp_prop, move_lnp, ndim)
        new_pos = torch.where(accept[..., None], prop, move_pos)
        new_lnp = torch.where(accept, lnp_prop, move_lnp)
        return new_pos, new_lnp, accept
    monkeypatch.setattr(affine, "_half_step", half_step)


FAULTS = {
    "unchanged": _stuck,
    "half": lambda mp: _patch_lnprob(mp, _half),
    "altered": lambda mp: _patch_lnprob(mp, _altered),
    "accept_all": lambda mp: _accept_step(
        mp, lambda lnz, lp, l0, d: torch.full_like(lp, torch.inf)),
    "wrong_z": lambda mp: _accept_step(
        mp, lambda lnz, lp, l0, d: d * lnz + lp - l0),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(root, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    result = run_tiny(root, "flagship.stretch", seed=2 ** 32 + 3,
                      seconds=0.1)
    assert result["attempted"] == 1
    assert result["correct"] is False, result["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the faults at the cell's own "
                    "size run on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["accept_all", "wrong_z"])
def test_accept_fault_is_not_correct_on_card(card, monkeypatch, fault):
    """Three seeds, each with a 10-s window of the cell's own fits. A
    chain that the fault fills with NaN stops the program's burn-in
    (a run that prints no result: not correct either)."""
    from portbench.harness import runner
    FAULTS[fault](monkeypatch)
    for k in range(3):
        try:
            result = runner.run(REPO, "flagship.stretch", 2 ** 31 + 31 + k,
                                10.0, 0, time.perf_counter())
        except ValueError as e:
            print(fault, "no result:", e)
            continue
        print(fault, result["checks"])
        assert result["correct"] is False, result["checks"]
