"""PyTorch port vs JAX package: ``fit_map`` of the free-completeness
``fit`` model (its alpha axis pinned at the box's upper bound on this
catalog), at the bars of ``tests/test_torch_mapfit.py``'s
:func:`check_fit_map`. A file of its own: the JAX package's batched
BFGS takes ~30 s to compile and run here on the CPU."""

import torch

from tests.test_torch_mapfit import check_fit_map

torch.set_num_threads(2)


def test_fit_map_matches_jax_free_completeness():
    _, got = check_fit_map("LumFuncModel", {})
    assert got["boundary"][-1]
