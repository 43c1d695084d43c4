"""The device grid (port of ``lumfuncmcmc_tpu/parallel/``): walker
sharding (the data-parallel analogue) and source sharding (the
sequence-parallel analogue) over ``torch.distributed`` ranks, one process
and one card a rank."""

from lumfuncmcmc_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from lumfuncmcmc_tpu_torch.parallel.sharding import (  # noqa: F401
    make_lnprob_sharded, pad_sources,
)
