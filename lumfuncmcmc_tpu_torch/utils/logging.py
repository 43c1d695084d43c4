"""Shared logger (port of ``lumfuncmcmc_tpu/utils/logging.py``): the
same format string, so downstream log parsers keep working."""

from __future__ import annotations

import logging


def setup_logging(name: str = "lumfuncmcmc_tpu_torch") -> logging.Logger:
    log = logging.getLogger(name)
    # outside the handler guard: with level left NOTSET the logger
    # inherits root's WARNING and drops every INFO line whenever an
    # embedding app (or a test capture) attached its own handler
    # before the first setup_logging call
    log.setLevel(logging.DEBUG)
    if not log.handlers:
        fmt = logging.Formatter("[%(levelname)s - %(asctime)s] %(message)s")
        handler = logging.StreamHandler()
        handler.setFormatter(fmt)
        handler.setLevel(logging.INFO)
        log.addHandler(handler)
        # the logger carries its own handler: without this, an
        # embedding app that configures root logging sees every line
        # twice
        log.propagate = False
    return log
