"""FLRW cosmology tables (port of ``lumfuncmcmc_tpu/cosmology.py``).

The float64 host tables (:func:`build_cosmo_arrays`) are carried over
unchanged; :class:`CosmoTable` holds them as tensors on the run's device
and evaluates them with :func:`interp`, a ``torch.searchsorted`` linear
interpolation with ``np.interp``'s clamp-to-end-values semantics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# --- physical constants (SI, CODATA 2018 — same family astropy uses) ---
_C_M_S = 2.99792458e8            # speed of light [m/s]
_G = 6.6743e-11                  # gravitational constant [m^3/kg/s^2]
_SIGMA_SB = 5.670374419e-8       # Stefan–Boltzmann [W/m^2/K^4]
_MPC_M = 3.0856775814913673e22   # megaparsec [m]

# the reference's cm/Mpc constant for the flux<->luminosity conversions
MPC_CM_REF = 3.086e24

# arcsec^2 per steradian
SQARCSEC_PER_SR = (180.0 / np.pi * 3600.0) ** 2


@dataclass(frozen=True)
class CosmologyParams:
    H0: float = 70.0          # km/s/Mpc
    Om0: float = 0.3
    Ode0: float = 0.7
    Tcmb0: float = 2.725      # K
    Neff: float = 3.04

    @property
    def h(self) -> float:
        return self.H0 / 100.0

    @property
    def hubble_distance_mpc(self) -> float:
        return _C_M_S / (self.H0 * 1000.0 / _MPC_M) / _MPC_M

    @property
    def Ogamma0(self) -> float:
        H0_si = self.H0 * 1000.0 / _MPC_M
        rho_crit = 3.0 * H0_si**2 / (8.0 * np.pi * _G)          # kg/m^3
        a_rad = 4.0 * _SIGMA_SB / _C_M_S                         # J/m^3/K^4
        rho_gamma = a_rad * self.Tcmb0**4 / _C_M_S**2            # kg/m^3
        return float(rho_gamma / rho_crit)

    @property
    def Onu0(self) -> float:
        # massless neutrinos: (7/8)(4/11)^{4/3} per effective species
        return float(self.Neff * 0.875 * (4.0 / 11.0) ** (4.0 / 3.0)
                     * self.Ogamma0)

    @property
    def Or0(self) -> float:
        return self.Ogamma0 + self.Onu0

    @property
    def Ok0(self) -> float:
        return 1.0 - self.Om0 - self.Ode0 - self.Or0


DEFAULT_COSMOLOGY = CosmologyParams()


def _efunc_np(z, p: CosmologyParams):
    zp1 = 1.0 + z
    return np.sqrt(p.Om0 * zp1**3 + p.Ok0 * zp1**2 + p.Or0 * zp1**4 + p.Ode0)


def interp(x, xp, fp):
    """Piecewise-linear interpolation, the semantics of ``np.interp`` /
    ``jnp.interp``: ``xp`` increasing, values outside ``[xp[0], xp[-1]]``
    clamp to ``fp[0]`` / ``fp[-1]``. Same formula as ``jnp.interp`` so
    float64 results agree to rounding."""
    x = torch.as_tensor(x, dtype=fp.dtype, device=fp.device)
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, xp.shape[0] - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    f = f0 + (x - x0) / (x1 - x0) * (f1 - f0)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@dataclass(frozen=True)
class CosmoTable:
    """Dense z-grid cosmology tables as tensors on the run's device."""

    zgrid: torch.Tensor        # (n,) dense redshift grid from 0
    dc_mpc: torch.Tensor       # (n,) line-of-sight comoving distance [Mpc]
    dm_mpc: torch.Tensor       # (n,) transverse comoving distance [Mpc]
    dl_mpc: torch.Tensor       # (n,) luminosity distance [Mpc]
    log10_dl_cm: torch.Tensor  # (n,) log10(dL in cm), 3.086e24 cm/Mpc
    dvdz_sr: torch.Tensor      # (n,) differential comoving volume [Mpc^3/sr]
    vc_sr: torch.Tensor        # (n,) cumulative comoving volume [Mpc^3/sr]

    def luminosity_distance(self, z):
        """dL(z) in Mpc."""
        return interp(z, self.zgrid, self.dl_mpc)

    def log10_dl_cm_at(self, z):
        """log10 of dL in cm."""
        return interp(z, self.zgrid, self.log10_dl_cm)

    def differential_comoving_volume(self, z):
        """dV/dz/dOmega in Mpc^3/sr."""
        return interp(z, self.zgrid, self.dvdz_sr)

    def comoving_volume_between(self, z_lo, z_hi):
        """int_{z_lo}^{z_hi} dV/dz dz per steradian [Mpc^3/sr]."""
        return (interp(z_hi, self.zgrid, self.vc_sr)
                - interp(z_lo, self.zgrid, self.vc_sr))

    def z_at_log10_dl_cm(self, log_dl_cm):
        """Invert the monotone log10 dL(z) table -> z."""
        return interp(log_dl_cm, self.log10_dl_cm, self.zgrid)


COSMO_FIELDS = ("zgrid", "dc_mpc", "dm_mpc", "dl_mpc", "log10_dl_cm",
                "dvdz_sr", "vc_sr")


def cosmo_table_from_arrays(tabs, device, dtype) -> CosmoTable:
    """:class:`CosmoTable` from a name -> array mapping (the output of
    :func:`build_cosmo_arrays`, or the JAX table's fields as numpy)."""
    return CosmoTable(*(torch.tensor(np.asarray(tabs[k]), dtype=dtype,
                                     device=device)
                        for k in COSMO_FIELDS))


def build_cosmo_arrays(zmax: float, n: int = 32768,
                       p: CosmologyParams = DEFAULT_COSMOLOGY) -> dict:
    """Host-side float64 cosmology tables, as a dict of numpy arrays."""
    zmax = float(max(zmax, 1e-3))
    ngrid = int(n) | 1  # odd count for Simpson pairs
    z = np.linspace(0.0, zmax, ngrid)
    dz = z[1] - z[0]
    inv_e = 1.0 / _efunc_np(z, p)

    # cumulative Simpson: integral up to each even node, then fill odd
    # nodes with local half-panel estimates.
    dc = np.zeros_like(z)
    panel = dz / 3.0 * (inv_e[0:-2:2] + 4.0 * inv_e[1:-1:2] + inv_e[2::2])
    dc[2::2] = np.cumsum(panel)
    # odd nodes: ∫_{x0}^{x1} ≈ dz/12 (5 f0 + 8 f1 − f2)
    dc[1::2] = dc[0:-1:2] + dz / 12.0 * (
        5.0 * inv_e[0:-1:2] + 8.0 * inv_e[1::2] - inv_e[2::2])

    d_h = p.hubble_distance_mpc
    dc_mpc = d_h * dc

    ok = p.Ok0
    if abs(ok) < 1e-12:
        dm_mpc = dc_mpc
    elif ok > 0:
        sq = np.sqrt(ok)
        dm_mpc = d_h / sq * np.sinh(sq * dc_mpc / d_h)
    else:
        sq = np.sqrt(-ok)
        dm_mpc = d_h / sq * np.sin(sq * dc_mpc / d_h)

    dl_mpc = (1.0 + z) * dm_mpc
    with np.errstate(divide="ignore"):
        log10_dl_cm = np.log10(dl_mpc * MPC_CM_REF)
    log10_dl_cm[0] = log10_dl_cm[1] - (log10_dl_cm[2] - log10_dl_cm[1])
    dvdz_sr = d_h * dm_mpc**2 / _efunc_np(z, p)

    # cumulative comoving volume per steradian, Vc(z) = int_0^z dV/dz dz
    vc = np.zeros_like(z)
    panel_v = dz / 3.0 * (dvdz_sr[0:-2:2] + 4.0 * dvdz_sr[1:-1:2]
                          + dvdz_sr[2::2])
    vc[2::2] = np.cumsum(panel_v)
    vc[1::2] = vc[0:-1:2] + dz / 12.0 * (
        5.0 * dvdz_sr[0:-1:2] + 8.0 * dvdz_sr[1::2] - dvdz_sr[2::2])

    return {"zgrid": z, "dc_mpc": dc_mpc, "dm_mpc": dm_mpc,
            "dl_mpc": dl_mpc, "log10_dl_cm": log10_dl_cm,
            "dvdz_sr": dvdz_sr, "vc_sr": vc}
