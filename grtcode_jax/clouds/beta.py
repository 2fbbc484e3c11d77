"""Incomplete beta function and its inverse.

The reference loads I_x(p, q) and its inverse from netCDF lookup tables
with linear interpolation (incomplete_beta.c:8-65).  Here the regularized
incomplete beta evaluates exactly via `jax.scipy.special.betainc`, and the
inverse is a fixed-iteration bisection (jit/vmap-friendly, no tables, and
more accurate than the reference's table interpolation).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import betainc


def beta_value(p, q, x):
    """Regularized incomplete beta I_x(p, q) (beta_value,
    incomplete_beta.c:60-66)."""
    x = jnp.clip(jnp.asarray(x, jnp.float32), 0.0, 1.0)
    return betainc(jnp.float32(p), jnp.float32(q), x)


def beta_inverse(p, q, y, iters: int = 40):
    """x such that I_x(p, q) = y, by bisection on the monotone CDF
    (beta_inverse, incomplete_beta.c:52-57)."""
    y = jnp.clip(jnp.asarray(y, jnp.float32), 0.0, 1.0)
    p = jnp.float32(p)
    q = jnp.float32(q)

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        below = betainc(p, q, mid) < y
        return jnp.where(below, mid, lo), jnp.where(below, hi, mid)

    lo, hi = jax.lax.fori_loop(
        0, iters, body, (jnp.zeros_like(y), jnp.ones_like(y)))
    return 0.5 * (lo + hi)
