"""Optical-property container and combination rules.

Re-design of Optics_t (utilities/src/optics.c:84-357).  Instead of
device pointers, ``Optics`` is a jax pytree of three arrays shaped
``(..., nlayers, nwavenumbers)`` — any leading axes are batch axes (columns,
time) that vmap/pjit shard transparently.
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from .spectral import SpectralGrid


@jax.tree_util.register_pytree_node_class
class Optics:
    """tau/omega/g on (..., layer, wavenumber); ``grid`` is static metadata."""

    def __init__(self, tau, omega, g, grid: SpectralGrid | None = None):
        self.tau = tau
        self.omega = omega
        self.g = g
        self.grid = grid

    # -- pytree protocol -------------------------------------------------
    def tree_flatten(self):
        return (self.tau, self.omega, self.g), self.grid

    @classmethod
    def tree_unflatten(cls, grid, children):
        return cls(*children, grid=grid)

    # -- constructors ----------------------------------------------------
    @classmethod
    def zeros(cls, num_layers: int, grid: SpectralGrid, dtype=jnp.float32,
              batch_shape: tuple = ()):
        shape = batch_shape + (num_layers, grid.n)
        z = jnp.zeros(shape, dtype=dtype)
        return cls(z, z, z, grid=grid)

    @classmethod
    def from_tau(cls, tau, grid: SpectralGrid | None = None):
        """Absorption-only optics (omega = g = 0), e.g. gas optical depth."""
        z = jnp.zeros_like(tau)
        return cls(tau, z, z, grid=grid)

    @property
    def num_layers(self) -> int:
        return self.tau.shape[-2]

    # -- operations ------------------------------------------------------
    def __add__(self, other: "Optics") -> "Optics":
        return combine([self, other])

    def update(self, tau=None, omega=None, g=None) -> "Optics":
        """Replace optical properties (update_optics, optics.c:345-357).

        Functional counterpart of the reference's in-place copy: returns a
        new Optics with the given fields swapped in (shapes must match)."""
        for name, new in (("tau", tau), ("omega", omega), ("g", g)):
            if new is not None and jnp.shape(new) != jnp.shape(self.tau):
                raise ValueError(
                    f"{name} shape {jnp.shape(new)} != {jnp.shape(self.tau)}")
        return Optics(self.tau if tau is None else jnp.asarray(tau),
                      self.omega if omega is None else jnp.asarray(omega),
                      self.g if g is None else jnp.asarray(g),
                      grid=self.grid)

    def sample(self, dest_grid: SpectralGrid, w0: float | None = None,
               wn: float | None = None) -> "Optics":
        """Down-sample onto a coarser sub-grid (optics.c sample_optics,
        :268-341): the destination grid must be a strided subdomain of the
        source; values are picked by striding (no averaging)."""
        if self.grid is None:
            raise ValueError("sample() requires grid metadata")
        lower = dest_grid.w0 if w0 is None else w0
        upper = dest_grid.last if wn is None else wn
        d0 = dest_grid.point_index(lower)
        dn = dest_grid.point_index(upper)
        s0 = self.grid.point_index(lower)
        sn = self.grid.point_index(upper)
        n_d = dn - d0 + 1
        n_s = sn - s0 + 1
        if n_d > n_s or (n_s - 1) % (n_d - 1) != 0:
            raise ValueError("destination grid must be a strided subdomain")
        factor = (n_s - 1) // (n_d - 1)
        sl = slice(s0, sn + 1, factor)
        return Optics(
            self.tau[..., sl], self.omega[..., sl], self.g[..., sl], grid=dest_grid
        )


def combine(optics_list: Sequence[Optics]) -> Optics:
    """Weighted combination of optical properties (optics.c:128-148):

    ``tau = sum tau_k``;  ``omega = sum omega_k tau_k / tau``;
    ``g = sum g_k omega_k tau_k / sum omega_k tau_k``.

    Zero denominators yield 0 instead of NaN (the reference relies on the
    consumer never reading g when nothing scatters; we make that explicit).
    """
    if not optics_list:
        raise ValueError("need at least one optics object")
    grid = optics_list[0].grid
    for o in optics_list[1:]:
        if grid is not None and o.grid is not None and o.grid != grid:
            raise ValueError("incompatible spectral grids")
    tau = sum(o.tau for o in optics_list)
    wtau = sum(o.omega * o.tau for o in optics_list)
    gwtau = sum(o.g * o.omega * o.tau for o in optics_list)
    omega = jnp.where(tau > 0, wtau / jnp.where(tau > 0, tau, 1.0), 0.0)
    g = jnp.where(wtau > 0, gwtau / jnp.where(wtau > 0, wtau, 1.0), 0.0)
    return Optics(tau, omega, g, grid=grid)
