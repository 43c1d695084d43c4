"""Likelihood context, engines, model drivers and V_eff."""

from lumfuncmcmc_tpu_torch.models.context import (  # noqa: F401
    LFData, LFContext, build_context,
)
from lumfuncmcmc_tpu_torch.models.likelihood import (  # noqa: F401
    ThetaLayout, make_lnprob, lnlike_single_epoch,
)
