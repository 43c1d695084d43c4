"""Run configuration for lumfuncmcmc_tpu_torch (the port's own copy of
``lumfuncmcmc_tpu/config.py``: same fields, defaults and merge rules, so
one config file or command line drives either package).

Replaces the reference's flat module config (``configLF.py:1-42``) with a
dataclass carrying the same field names and defaults, merged with CLI
overrides under the precedence CLI > config-file > defaults.  Unlike the
reference driver (``run_lumfuncmcmc.py:120-127``), a flag value of ``0``
does NOT silently fall back to the config default — only ``None`` (unset)
does.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from dataclasses import dataclass, field
from typing import Any, Optional


# Default per-field 50%-completeness fluxes (units of 1e-17 erg/cm^2/s) for
# the five HST-grism fields (AEGIS, COSMOS, GOODSN, GOODSS, UDS), matching
# configLF.py:6 of the reference.
_DEFAULT_FLIM = (2.72, 3.61, 2.55, 3.31, 3.30)

# Effective survey areas: sq-arcmin values * 0.85 usable fraction * 3600
# arcsec^2 per arcmin^2 (configLF.py:18-21).
_DEFAULT_OMEGA_SQARCMIN = (121.9, 122.2, 116.0, 147.3, 118.7)
_DEFAULT_FRAC_USE = 0.85
_DEFAULT_OMEGA_0 = tuple(v * _DEFAULT_FRAC_USE * 3600.0 for v in _DEFAULT_OMEGA_SQARCMIN)


@dataclass
class LFConfig:
    """All knobs for a luminosity-function fit.

    Field names follow ``configLF.py`` in the reference so users can port
    their configs directly.
    """

    # --- sampler scale (configLF.py:1-2) ---
    nwalkers: int = 100
    nsteps: int = 1000

    # --- V_eff estimator (configLF.py:3-4) ---
    nbins: int = 50
    nboot: int = 100

    # --- completeness curve (configLF.py:6-13) ---
    Flim: tuple = _DEFAULT_FLIM            # per-field F50, 1e-17 cgs
    survey_fields: tuple = ("AEGIS", "COSMOS", "GOODSN", "GOODSS",
                            "UDS")         # field names aligned with
                                           #   Flim/Omega_0 entries (the
                                           #   reference's 5 grism
                                           #   fields, lumfuncmcmc.py:91)
                                           #   — lets catalogs with a
                                           #   SUBSET of fields match by
                                           #   NAME instead of silently
                                           #   taking the wrong limits
    Flim_lims: tuple = (1.0, 6.0)
    alpha: float = 4.56                    # Fleming slope
    alpha_lims: tuple = (1.0, 7.0)
    fcmin: float = 0.1                     # faint-end modification threshold
    min_comp_frac: float = 0.0

    # --- line identity (configLF.py:14-17) ---
    line_name: str = "OIII"
    line_plot_name: str = r"[OIII] $\lambda 5007$"

    # --- survey area (configLF.py:18-22) ---
    Omega_0: tuple = _DEFAULT_OMEGA_0      # arcsec^2 per field

    # --- Schechter parameters and priors (configLF.py:23-28) ---
    sch_al: float = -1.49
    sch_al_lims: tuple = (-3.0, 1.0)
    Lstar: float = 42.5
    Lstar_lims: tuple = (40.0, 45.0)
    phistar: float = -2.0
    phistar_lims: tuple = (-8.0, 5.0)

    # --- likelihood integral bounds (configLF.py:29-30) ---
    Lc: float = 40.0
    Lh: float = 46.0

    # --- model toggles (LumFuncMCMC.__init__ kwargs) ---
    fix_sch_al: bool = False
    fix_comp: bool = False
    diff_rand: bool = True                 # False = reference's -sr/--same_rand

    # --- redshift-evolution pivot points (lumfuncmcmc_z defaults) ---
    z1: float = 1.20
    z2: float = 1.53
    z3: float = 1.86
    z_param: str = "pivots"                # "pivots" (reference) |
                                           #   "natural" (value/slope/
                                           #   curvature at z2 — flat
                                           #   prior on the curvature
                                           #   direction)

    # --- outputs (configLF.py:33-42) ---
    param_percentiles: tuple = (5, 16, 50, 84, 95)
    output_dict: dict = field(default_factory=lambda: {
        "parameters": True,
        "settings": True,
        "fitposterior": True,
        "bestfitLF": True,
        "VeffLF": True,
        "triangle plot": True,
        "image format": "png",
    })

    # --- new knobs (no reference counterpart) ---
    seed: int = 42                         # global PRNG seed (reference had none)
    sampler: str = "stretch"               # "stretch" | "nuts"
    move: str = "stretch"                  # ensemble proposal:
                                           #   "stretch" (reference
                                           #   semantics) | "de"
                                           #   (differential evolution)
                                           #   | "mix" (50/50 per step)
    de_prob: float = 0.5                   # move="mix": fraction of DE
                                           #   steps (deterministic
                                           #   Bresenham schedule); the
                                           #   flagship optimum sits
                                           #   near 0.7 (PERFORMANCE.md
                                           #   sweep); 0.5 = emcee-style
                                           #   equal weighting
    use_x64: Optional[bool] = None         # None = auto (x64 on CPU, f32 on TPU)
    size_ln: Optional[int] = None          # likelihood grid size; None = reference
                                           #   rule (101 free-comp / 201 fixed-comp,
                                           #   lumfuncmcmc.py:219-220)
    quadrature: str = "trapz"              # "trapz" (reference parity) | "gauss"
    exact_bounds: bool = False             # free-comp: re-derive the
                                           #   completeness integration bound
                                           #   from theta each eval (the
                                           #   reference freezes it; its exact
                                           #   routine is dead code,
                                           #   lumfuncmcmc.py:372)
    use_pallas: Optional[bool] = None      # fused Pallas likelihood kernel;
                                           #   None = auto (on for TPU
                                           #   backends, off elsewhere)
    pallas_interpret: bool = False         # run the kernel in the Pallas
                                           #   interpreter (CPU tests/debug)
    init_map: bool = False                 # start walkers from the
                                           #   Laplace approximation
                                           #   around the MAP (2x
                                           #   overdispersed) instead of
                                           #   uniform box draws —
                                           #   slashes burn-in on
                                           #   well-behaved posteriors
    nuts_target_accept: float = 0.8        # NUTS dual-averaging target
                                           #   acceptance (Stan default;
                                           #   measured throughput
                                           #   winner once bad starts
                                           #   are resampled — raise if
                                           #   divergences are reported;
                                           #   see PERFORMANCE.md)
    thin: int = 1                          # record every thin-th step
                                           #   (memory guard for very long
                                           #   chains; reference stores all)
    checkpoint_every: int = 0              # steps between chain checkpoints (0=off)
    mesh_walkers: int = 0                  # device-mesh walker axis (0 = all devices)
    mesh_sources: int = 1                  # device-mesh source axis

    def replace(self, **kw: Any) -> "LFConfig":
        return dataclasses.replace(self, **kw)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def field_names(cls):
        return [f.name for f in dataclasses.fields(cls)]


def load_config_file(path: str) -> dict:
    """Load overrides from a JSON file or a flat Python module (configLF style)."""
    if path.endswith(".json"):
        with open(path) as fh:
            return json.load(fh)
    spec = importlib.util.spec_from_file_location("user_configLF", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    names = set(LFConfig.field_names())
    return {k: v for k, v in vars(mod).items() if k in names}


def merge_config(defaults: LFConfig, file_overrides: dict | None,
                 cli_overrides: dict | None) -> LFConfig:
    """CLI > config-file > defaults. ``None`` CLI values mean unset."""
    cfg = defaults
    if file_overrides:
        cfg = cfg.replace(**{k: v for k, v in file_overrides.items()
                             if k in LFConfig.field_names()})
    if cli_overrides:
        cfg = cfg.replace(**{k: v for k, v in cli_overrides.items()
                             if v is not None and k in LFConfig.field_names()})
    return cfg
