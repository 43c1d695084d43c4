"""Likelihood context, engines, model drivers and V_eff."""
