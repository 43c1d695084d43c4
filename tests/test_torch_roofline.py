"""PyTorch port vs JAX package: the same-mix roofline microbenchmark
(``ops/roofline.py`` vs ``ops/pallas_roofline.py``).

The op chain matches the JAX ``_chain`` at rtol 1e-6 after 1 and 50
iterations (float32 on both sides, the same operations in the same
order; the chain contracts, so rounding does not grow). The timing runs
here on the CPU only to check its bookkeeping, never as a device rate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.ops import pallas_roofline as jr
from lumfuncmcmc_tpu_torch.ops import roofline as rl

Y = np.linspace(0.06, 0.94, 128).astype(np.float32)


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
