"""``python -m lumfuncmcmc_tpu_torch`` entry point."""

import sys

from lumfuncmcmc_tpu_torch.cli.main import main

sys.exit(main())
