"""lumfuncmcmc_tpu_torch — the PyTorch/CUDA port of ``lumfuncmcmc_tpu``.

The JAX package beside it is the reference every module here is tested
against. This package imports ``torch`` and never ``jax``, and nothing
of the JAX package: ``config`` and ``native`` (the C catalog reader) are
its own copies.

Layout mirrors the JAX package, module for module, for the single-epoch
``fit`` path: host float64 precompute (``models.context``), an eager
batched likelihood engine (``models.likelihood``), hand-written CUDA
likelihood kernels, value and value+gradient (``csrc/lnlike.cu``
behind ``ops.cuda_lnlike``), the stretch/DE/mix
ensemble sampler (``samplers.affine``), batched NUTS
(``samplers.nuts``, ``models.nuts_driver``), the 1/V_eff cross-check
(``models.veff``) and the ``fit`` CLI.
"""

__version__ = "0.1.0"

from lumfuncmcmc_tpu_torch.config import LFConfig  # noqa: F401
