"""Math on tensors: Schechter forms, completeness, Omega, quadrature.
The CUDA likelihood kernels (``cuda_lnlike``, built by ``_build``) are
imported by name, so importing this package builds and loads none."""

from lumfuncmcmc_tpu_torch.ops.schechter import (  # noqa: F401
    true_lum_func,
    log_true_lum_func,
    schechter,
    schechter_log,
    schechter_integ,
    schechter_integ_log,
    quad_coef,
    schechter_z,
    log_schechter_z,
)
from lumfuncmcmc_tpu_torch.ops.completeness import (  # noqa: F401
    fleming_from_logf,
    fleming,
    inverse_fleming,
    expdecay,
    fleming_root_logf,
    p_curve,
)
from lumfuncmcmc_tpu_torch.ops.omega import (  # noqa: F401
    omega, omega_from_logf,
)
from lumfuncmcmc_tpu_torch.ops.gamma import upper_gamma  # noqa: F401
