"""Shortwave solver: delta-Eddington + Meador-Weaver two-stream + adding.

Re-design of sw_flux / sw_fluxes_kernel
(shortwave/src/shortwave.c:68-501).  The per-layer two-stream R/T
computations (delta-Eddington scaling per Joseph-Wiscombe-Weinman 1976;
Meador & Weaver 1980 eq. 14/15/24 with the Eddington gamma row of their
table 1) are elementwise over (layer, wavenumber); the reference's scalar
branches become ``jnp.where`` selects.  The adding method
(Briegleb 1992 appendix) runs as three ``lax.scan`` level recurrences.

Shapes as in longwave: (..., nlayers, nw) optics; returns per-wavenumber
fluxes (..., nlevels, nw) scaled by TSI * solar_flux(w) * mu_dir
(shortwave.c:400-404, 448-449).  Level index 0 = top of atmosphere.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import constants

_MAXEXP = constants.MAX_EXP_ARG


def delta_eddington_scale(omega, g, tau):
    """JWW 1976 eq. 5/13/14 (shortwave.c:68-92): g' = g/(1+g), f = g^2,
    omega' = (1-f) omega / (1 - omega f), tau' = tau (1 - omega f)."""
    g_s = g / (g + 1.0)
    f = g * g
    omega_s = (1.0 - f) * omega / (1.0 - omega * f)
    tau_s = tau * (1.0 - omega * f)
    return omega_s, g_s, tau_s


def meador_weaver(omega, tau, mu, gamma1, gamma2, gamma3, want_pure: bool):
    """Layer reflectivity/transmittance, Meador & Weaver 1980 eq. 14/15/24
    (shortwave.c:97-207).

    Reformulated for f32: the reference evaluates eq. 14/15 with growing
    exponentials exp(t*k), exp(t/mu) and clamps t so doubles don't overflow
    (shortwave.c:133-145).  Here both numerator and denominator are divided
    through by exp(t*k), leaving only decaying exponentials
    e1 = exp(-t/mu), ek = exp(-t*k), e2 = exp(-2 t*k) in (0, 1] — the same
    expression exactly, but overflow-free at any optical depth, so no clamps
    are needed (underflow to 0 reproduces the reference's clamped limit).

    All branches evaluate elementwise and are combined with selects:
      omega <= 0       -> R = 0, T = exp(-tau/mu)
      tau <= 0 (no gas)-> R = 0, T = 1
      omega >= 1       -> conservative scattering (eq. 24)
      else             -> general two-stream (eq. 14/15)
    """
    gamma4 = 1.0 - gamma3
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4
    ksq = gamma1 * gamma1 - gamma2 * gamma2
    k = jnp.sqrt(jnp.maximum(ksq, 1e-12))

    t = tau
    e1 = jnp.exp(-t / mu)      # = reference tm
    ek = jnp.exp(-t * k)       # = reference tkm
    e2 = ek * ek               # = tkm / tkp

    # Conservative scattering (eq. 24).
    r_cons = (1.0 / (1.0 + gamma1 * t)) * (gamma1 * t + (gamma3 - gamma1 * mu)
                                           * (1.0 - e1))
    t_cons = 1.0 - r_cons

    # General case (eq. 14/15), scaled by exp(-t*k); singular only at
    # k*mu == 1 (removable), guarded with a tiny floor.
    denom = (1.0 - k * k * mu * mu) * ((k + gamma1) + (k - gamma1) * e2)
    denom = jnp.where(jnp.abs(denom) < 1e-12,
                      jnp.where(denom < 0, -1e-12, 1e-12), denom)
    r_gen = (omega / denom) * ((1.0 - k * mu) * (alpha2 + k * gamma3)
                               - (1.0 + k * mu) * (alpha2 - k * gamma3) * e2
                               - 2.0 * k * (gamma3 - alpha2 * mu) * e1 * ek)
    t_gen = e1 - (omega / denom) * (
        (1.0 + k * mu) * (alpha1 + k * gamma4) * e1
        - (1.0 - k * mu) * (alpha1 - k * gamma4) * e1 * e2
        - 2.0 * k * (gamma4 + alpha1 * mu) * ek)

    tm = e1
    no_scatter = omega <= 0.0
    no_gas = tau <= 0.0
    conservative = omega >= 1.0

    r = jnp.where(no_scatter, 0.0,
                  jnp.where(no_gas, 0.0,
                            jnp.where(conservative, r_cons, r_gen)))
    tr = jnp.where(no_scatter, tm,
                   jnp.where(no_gas, 1.0,
                             jnp.where(conservative, t_cons, t_gen)))
    if not want_pure:
        return r, tr, None
    t_pure = jnp.where(no_scatter, tm, jnp.where(no_gas, 1.0, tm))
    # T may not fall below the unscattered direct transmission
    # (shortwave.c:199-205).
    tr = jnp.maximum(tr, t_pure)
    return r, tr, t_pure


def eddington(omega, tau, mu, g, want_pure: bool):
    """Eddington gamma coefficients (MW 1980 table 1 row 1; shortwave.c:214-236)."""
    gamma1 = 0.25 * (7.0 - omega * (4.0 + 3.0 * g))
    gamma2 = -0.25 * (1.0 - omega * (4.0 - 3.0 * g))
    gamma3 = 0.25 * (2.0 - 3.0 * g * mu)
    return meador_weaver(omega, tau, mu, gamma1, gamma2, gamma3, want_pure)


def _sw_adding(r_dir, r_dif, t_dir, t_dif, t_pure, alpha_dir, alpha_dif):
    """Adding method (Briegleb 1992 appendix; shortwave.c:242-330).

    Layer arrays are (nlayers, nw); surface albedos (nw,).  Returns
    normalized (R, T) at each level, (nlevels, nw): total upward reflectance
    and downward transmittance for unit TOA direct beam.
    """
    nw = r_dir.shape[-1]
    dtype = r_dir.dtype

    # Downward-beam reflectances built from the surface up (shortwave.c:272-289).
    def up_build(carry, x):
        rdir_dn_below, rdif_dn_below = carry
        rd, rf, td, tf, tp = x
        b = 1.0 / (1.0 - rf * rdif_dn_below)
        rdir_dn = rd + (tp * rdir_dn_below
                        + (td - tp) * rdif_dn_below) * tf * b
        rdif_dn = rf + tf * tf * rdif_dn_below * b
        return (rdir_dn, rdif_dn), (rdir_dn, rdif_dn)

    init = (jnp.broadcast_to(alpha_dir, (nw,)).astype(dtype),
            jnp.broadcast_to(alpha_dif, (nw,)).astype(dtype))
    _, (rdir_dn_scan, rdif_dn_scan) = jax.lax.scan(
        up_build, init, (r_dir, r_dif, t_dir, t_dif, t_pure), reverse=True)
    # Level arrays: index i = reflectance of everything below level i.
    r_dir_down = jnp.concatenate([rdir_dn_scan, init[0][None, :]], axis=0)
    r_dif_down = jnp.concatenate([rdif_dn_scan, init[1][None, :]], axis=0)

    # Upward-beam reflectances built from the top down (shortwave.c:291-302);
    # r_dif_up[i] = reflectance (for upward beams) of layers 0..i.
    def down_build(carry, x):
        rf, tf = x
        b = 1.0 / (1.0 - rf * carry)
        r_up = rf + tf * tf * carry * b
        return r_up, r_up

    _, rdif_up_scan = jax.lax.scan(
        down_build, r_dif[0], (r_dif[1:], t_dif[1:]))
    r_dif_up = jnp.concatenate([r_dif[0][None, :], rdif_up_scan], axis=0)
    # Extended with a leading zero so index i-2 at i=1 reads 0
    # (matches the i==1 special case, shortwave.c:313-321).
    r_dif_up_ext = jnp.concatenate(
        [jnp.zeros((1, nw), dtype), r_dif_up], axis=0)

    # Beam propagation top -> bottom (shortwave.c:304-328).
    def beam_step(carry, x):
        dir_beam, dif_beam = carry
        rd, rf, td, tf, tp, rdir_dn, rdif_dn, rup_im1, rup_im2 = x
        c = 1.0 / (1.0 - rf * rup_im2)
        dif_beam = (dir_beam * rd * rup_im2 + dif_beam) * tf * c \
            + dir_beam * (td - tp)
        dir_beam = dir_beam * tp
        b = 1.0 / (1.0 - rdif_dn * rup_im1)
        r_lev = (dir_beam * rdir_dn + dif_beam * rdif_dn) * b
        t_lev = dir_beam * (1.0 + rdir_dn * rup_im1 * b) + dif_beam * b
        return (dir_beam, dif_beam), (r_lev, t_lev)

    ones = jnp.ones((nw,), dtype)
    zeros = jnp.zeros((nw,), dtype)
    xs = (r_dir, r_dif, t_dir, t_dif, t_pure,
          r_dir_down[1:], r_dif_down[1:], r_dif_up, r_dif_up_ext[:-1])
    _, (r_levels, t_levels) = jax.lax.scan(beam_step, (ones, zeros), xs)
    r = jnp.concatenate([(r_dir_down[0] * ones)[None, :], r_levels], axis=0)
    t = jnp.concatenate([ones[None, :], t_levels], axis=0)
    return r, t


def _sw_column(tau, omega, g, mu_dir, mu_dif, alpha_dir, alpha_dif, tsi,
               solar_flux):
    omega_s, g_s, tau_s = delta_eddington_scale(omega, g, tau)
    r_dir, t_dir, t_pure = eddington(omega_s, tau_s, mu_dir, g_s, True)
    r_dif, t_dif, _ = eddington(omega_s, tau_s, mu_dif, g_s, False)
    r, t = _sw_adding(r_dir, r_dif, t_dir, t_dif, t_pure, alpha_dir, alpha_dif)
    scale = (tsi * mu_dir) * solar_flux[None, :]
    return r * scale, t * scale


def shortwave_fluxes(tau, omega, g, mu_dir, mu_dif, alpha_dir, alpha_dif,
                     total_solar_irradiance, solar_flux):
    """Shortwave up/down fluxes per wavenumber at every level.

    Args:
      tau, omega, g: (..., nlayers, nw).
      mu_dir, mu_dif: (...,) beam cosines.
      alpha_dir, alpha_dif: (..., nw) surface albedos.
      total_solar_irradiance: (...,) [W m-2].
      solar_flux: (nw,) normalized incident flux (integrates to 1 over w).

    Returns (flux_up, flux_down), each (..., nlevels, nw) [W cm m-2].
    """
    fn = _sw_column
    batch_ndim = tau.ndim - 2
    for _ in range(batch_ndim):
        fn = jax.vmap(fn, in_axes=(0, 0, 0, 0, 0, 0, 0, 0, None))
    return fn(tau, omega, g, mu_dir, mu_dif, alpha_dir, alpha_dif,
              total_solar_irradiance, solar_flux)
