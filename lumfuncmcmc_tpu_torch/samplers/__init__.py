"""Ensemble sampler and chain diagnostics."""

from lumfuncmcmc_tpu_torch.samplers.affine import (  # noqa: F401
    run_stretch, step,
)
from lumfuncmcmc_tpu_torch.samplers.diagnostics import (  # noqa: F401
    integrated_autocorr_time, effective_sample_size, gelman_rubin,
    rank_normalized_rhat,
    burnin_steps,
)
