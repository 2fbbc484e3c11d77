"""Four-stream longwave solver.

Re-design of lw_flux / lw_fluxes_kernel (longwave/src/longwave.c:127-307):
the per-wavenumber CUDA thread becomes the vector axis; the layer recurrences
(down then up pass) become two ``lax.scan`` calls whose carries hold all four
streams at every wavenumber simultaneously.  Absorption-only:
``tau_eff = tau (1 - omega)`` (longwave.c:253).

Shapes: tau/omega are (..., nlayers, nw); temperatures (..., nlayers) /
(..., nlevels); emissivity (..., nw).  Leading batch axes vmap/shard freely.
Returned fluxes are per-wavenumber [W cm m-2], shape (..., nlevels, nw).

Level ordering: index 0 is the top of atmosphere, the last level is the
surface (the reference's down pass starts at level 0 with zero incoming
flux, longwave.c:192-203).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .. import constants
from .planck import effective_planck, planck_law


def stream_sum(c2, intensity):
    """Quadrature over the four streams: sum_j c2_j I_j of (..., 4, nw).

    A float32 matmul; pinned to HIGHEST because a GPU's default precision
    may run it in TF32 (about three decimal digits)."""
    return jnp.einsum("j,...jw->...w", c2, intensity,
                      precision=jax.lax.Precision.HIGHEST)


def _lw_column(tau_eff, t_surf, t_layers, t_levels, emis, w):
    """Single-column solve: tau_eff (nlayers, nw), w (nw,), emis (nw,)."""
    c1 = jnp.asarray(constants.LW_STREAM_SECANTS, tau_eff.dtype)  # (4,)
    c2 = jnp.asarray(constants.LW_STREAM_WEIGHTS, tau_eff.dtype)

    # Extinction per stream: exp(min(c1_j tau, MAX_EXP_ARG)) (longwave.c:179-190).
    e = jnp.minimum(c1[:, None, None] * tau_eff[None, :, :], constants.MAX_EXP_ARG)
    ext = jnp.exp(e)  # (4, nlayers, nw)

    # Effective Planck sources for the two passes (longwave.c:197, 213).
    b_down = effective_planck(t_layers[:, None], t_levels[1:, None], w[None, :],
                              tau_eff)  # (nlayers, nw)
    b_up = effective_planck(t_layers[:, None], t_levels[:-1, None], w[None, :],
                            tau_eff)

    # Downward pass (longwave.c:192-203): I_{i+1} = (1-ext_i) B_i + I_i ext_i.
    def down_step(carry, x):
        ext_i, b_i = x
        i_down = (1.0 - ext_i) * b_i[None, :] + carry * ext_i
        return i_down, i_down

    zero = jnp.zeros((4, w.shape[0]), tau_eff.dtype)
    i_down_sfc, i_down_levels = jax.lax.scan(
        down_step, zero, (jnp.moveaxis(ext, 1, 0), b_down))
    # flux_down[0] = 0; flux_down[i+1] = sum_j c2_j I_down.
    flux_down = jnp.concatenate(
        [jnp.zeros((1, w.shape[0]), tau_eff.dtype),
         stream_sum(c2, i_down_levels)], axis=0)

    # Surface reflection + emission (longwave.c:206-209).
    b_surf = planck_law(t_surf, w)  # (nw,)
    i_up0 = emis[None, :] * b_surf[None, :] + (1.0 - emis[None, :]) * i_down_sfc

    # Upward pass (longwave.c:210-219), bottom layer to top.
    def up_step(carry, x):
        ext_i, b_i = x
        i_up = (1.0 - ext_i) * b_i[None, :] + carry * ext_i
        return i_up, i_up

    _, i_up_levels = jax.lax.scan(
        up_step, i_up0, (jnp.moveaxis(ext, 1, 0), b_up), reverse=True)
    flux_up = jnp.concatenate(
        [stream_sum(c2, i_up_levels), stream_sum(c2, i_up0)[None, :]],
        axis=0)
    return flux_up, flux_down


@partial(jax.jit, static_argnames=())
def longwave_fluxes(tau, omega, t_surf, t_layers, t_levels, emis, w):
    """Longwave up/down fluxes per wavenumber at every level.

    Args:
      tau, omega: (..., nlayers, nw) optical depth / single-scatter albedo.
      t_surf: (...,) surface temperature [K].
      t_layers: (..., nlayers); t_levels: (..., nlevels).
      emis: (..., nw) surface emissivity.
      w: (nw,) wavenumbers [cm-1].

    Returns (flux_up, flux_down), each (..., nlevels, nw) in W cm m-2.
    """
    tau_eff = tau * (1.0 - omega)
    fn = _lw_column
    batch_ndim = tau.ndim - 2
    for _ in range(batch_ndim):
        fn = jax.vmap(fn, in_axes=(0, 0, 0, 0, 0, None))
    return fn(tau_eff, t_surf, t_layers, t_levels, emis, w)
