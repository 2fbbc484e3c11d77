"""Uniform spectral (wavenumber) grids.

Re-design of the reference SpectralGrid_t
(utilities/src/spectral_grid.c:32-112).  The grid is static metadata (hashable,
usable as a jit static argument); wavenumber arrays are generated on demand.
"""
from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np

from . import constants


@dataclasses.dataclass(frozen=True)
class SpectralGrid:
    """Uniform wavenumber grid: points ``w0 + i * dw`` for ``i in [0, n)``.

    Mirrors create_spectral_grid (spectral_grid.c:50-67): ``n`` is
    ``ceil((wn - w0)/dw) + 1``; the nominal upper bound ``wn`` may not lie on
    the grid if the range does not divide evenly.
    """

    w0: float
    wn: float
    dw: float

    def __post_init__(self):
        if not (constants.MIN_WAVENUMBER <= self.w0 <= constants.MAX_WAVENUMBER):
            raise ValueError(f"w0 {self.w0} outside valid range")
        if not (self.w0 < self.wn <= constants.MAX_WAVENUMBER):
            raise ValueError(f"wn {self.wn} outside valid range")
        if not (constants.MIN_RESOLUTION <= self.dw <= constants.MAX_RESOLUTION):
            raise ValueError(f"dw {self.dw} outside valid range")

    @property
    def n(self) -> int:
        return int(math.ceil((self.wn - self.w0) / self.dw)) + 1

    @property
    def last(self) -> float:
        """Largest wavenumber actually on the grid."""
        return self.w0 + (self.n - 1) * self.dw

    def wavenumbers(self, dtype=jnp.float32) -> jnp.ndarray:
        """All grid points as a device array (spectral_grid.c:88-100)."""
        return self.w0 + self.dw * jnp.arange(self.n, dtype=dtype)

    def wavenumbers_np(self, dtype=np.float64) -> np.ndarray:
        """All grid points as a host numpy array (float64 by default)."""
        return self.w0 + self.dw * np.arange(self.n, dtype=dtype)

    def point_index(self, w: float) -> int:
        """Index of a wavenumber that must lie on the grid
        (spectral_grid.c:71-84, tolerance dw*1e-5)."""
        if not (self.w0 <= w <= self.wn):
            raise ValueError(f"wavenumber {w} outside grid [{self.w0}, {self.wn}]")
        index = int(round((w - self.w0) / self.dw))
        if abs(self.w0 + index * self.dw - w) > self.dw * 1e-5:
            raise ValueError(f"wavenumber {w} not located on grid")
        return index

    def __eq__(self, other) -> bool:
        # compare_spectral_grids (spectral_grid.c:32-47).
        if not isinstance(other, SpectralGrid):
            return NotImplemented
        return self.w0 == other.w0 and self.wn == other.wn and self.dw == other.dw

    def __hash__(self) -> int:
        return hash((self.w0, self.wn, self.dw))
