"""PyTorch port vs JAX package: the same-mix roofline microbenchmark
(``ops/roofline.py`` vs ``ops/pallas_roofline.py``).

The op chain matches the JAX ``_chain`` at rtol 1e-6 after 1 and 50
iterations (float32 on both sides, the same operations in the same
order; the chain contracts, so rounding does not grow). The timing runs
here on the CPU only to check its bookkeeping, never as a device rate.
The CUDA chain's calls are read from its source: they must be the value
kernel's ln fc (``ln_fc_sfu``) plus the integrand's ``expf``.
"""

import collections
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.ops import pallas_roofline as jr
from lumfuncmcmc_tpu_torch.ops import roofline as rl

Y = np.linspace(0.06, 0.94, 128).astype(np.float32)
CSRC = pathlib.Path(rl.__file__).resolve().parents[1] / "csrc"


@pytest.mark.parametrize("iters", [1, 50])
def test_chain_matches_the_jax_chain(iters):
    y, z = torch.tensor(Y), jnp.asarray(Y)
    for _ in range(iters):
        z = jr._chain(z)
    got = rl.roofline_chain(y, iters)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(z), rtol=1e-6)
    np.testing.assert_array_equal(got.numpy(),
                                  rl.roofline_chain_reference(y, iters))


def test_chain_stays_inside_its_clamp_and_moves_its_input():
    """Iterating the chain cannot drift to inf/NaN, and one application
    changes a generic input (a fixed point would let a compiler collapse
    the loop)."""
    y = torch.tensor(Y)
    out = rl._chain(y)
    assert ((out >= 0.05) & (out <= 0.95)).all()
    assert not torch.allclose(out, y)
    z = rl.roofline_chain(y, 1000)
    assert torch.isfinite(z).all()


def test_transcendental_peak_keeps_the_jax_keys_and_bookkeeping():
    assert rl.TRANSCENDENTALS_PER_ELEM == jr.TRANSCENDENTALS_PER_ELEM
    r = rl.transcendental_peak("cpu", rows=8, cols=128, iters_lo=2,
                               iters_hi=6, reps=2)
    want = jr.transcendental_peak(rows=8, cols=128, iters_lo=2, iters_hi=6,
                                  reps=1, interpret=True)
    assert set(r) == set(want)
    assert r["transcendentals_per_sec"] > 0 and r["per_iter_s"] > 0
    assert r["elements_per_sec"] * rl.TRANSCENDENTALS_PER_ELEM == \
        r["transcendentals_per_sec"]
    assert (r["rows"], r["cols"], r["iters_lo"], r["iters_hi"],
            r["reps"]) == (8, 128, 2, 6, 2)


def test_roofline_chain_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="unsupported device"):
        rl.roofline_chain(torch.zeros(4, device="meta"), 3)
    n0 = rl.roofline_chain.launches
    rl.roofline_chain(torch.tensor(Y), 2)           # the CPU: no launch
    assert rl.roofline_chain.launches == n0


def _body(path, signature):
    """The body of the function whose definition contains ``signature``
    in a CUDA source, comments removed."""
    src = re.sub(r"//[^\n]*", "", (CSRC / path).read_text())
    start = src.index(signature)
    i = src.index("{", start)
    depth = 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[i + 1:j]
    raise AssertionError(f"unbalanced braces after {signature}")


def _calls(body):
    """Every function called in ``body``, ``ln_fleming_sfu`` (common.cuh)
    expanded into its own calls."""
    calls = collections.Counter(re.findall(r"\b(\w+)\s*\(", body))
    n = calls.pop("ln_fleming_sfu", 0)
    if n:
        helper = _calls(_body("common.cuh", "float ln_fleming_sfu("))
        for name, k in helper.items():
            calls[name] += n * k
    return calls


def test_cuda_chain_runs_the_value_kernels_sfu_mix():
    """roofline.cu's chain calls rsqrtf, __logf, expf, __fdividef and
    expf: ln_fc_sfu's calls (lnlike.cu) plus the integrand's exp, with
    no accurate logf and no IEEE divide anywhere in it."""
    allowed = {"fmaxf", "fminf", "if"}
    chain = _body("roofline.cu", "float chain(float y)")
    sfu = _body("lnlike.cu", "float ln_fc_sfu(")
    for body in (chain, sfu, _body("common.cuh", "float ln_fleming_sfu(")):
        assert "/" not in body                      # no IEEE divide
        assert not re.search(r"(?<![\w])logf\s*\(", body)
    got = {k: v for k, v in _calls(chain).items() if k not in allowed}
    assert got == {"rsqrtf": 1, "__logf": 1, "expf": 2, "__fdividef": 1}
    want = collections.Counter(
        {k: v for k, v in _calls(sfu).items() if k not in allowed})
    want["expf"] += 1                               # the integrand
    assert got == dict(want)
