"""Hu & Stamnes (1993) liquid cloud optics parameterization.

Re-design of the reference's legacy liquid parameterization
(clouds/liquid_cloud_optics.c:12-104, doi:10.1175/1520-0442(1993)006
<0728:AAPOTR>2.0.CO;2): per (radius-bin, band) power-law fits

    extinction [1/km]       = wc * 1e-3 * (a1 r^b1 + c1)     (eq. 13)
    single-scatter albedo   = 1 - (a2 r^b2 + c2)             (eq. 14)
    asymmetry factor        = a3 r^b3 + c3                   (eq. 15)

with the equivalent radius clamped to the table's valid range and the
radius bin chosen by upper-bound search (liquid_cloud_optics.c:18-27).
The per-scalar C loop becomes one vectorized gather over (..., band).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

_M_TO_KM = 1.0e-3  # liquid_cloud_optics.c:25


@dataclasses.dataclass
class HuStamnesLiquidOptics:
    """Coefficient tables on (num_radius_bins, num_bands).

    ``radii`` holds the num_radius_bins+1 bin edges (the reference packs
    lower bounds plus the final upper bound, liquid_cloud_optics.c:49-56);
    ``band_lims`` is (2, num_bands) wavenumber bounds [cm-1].
    """

    radii: np.ndarray
    band_lims: np.ndarray
    a1: jnp.ndarray
    b1: jnp.ndarray
    c1: jnp.ndarray
    a2: jnp.ndarray
    b2: jnp.ndarray
    c2: jnp.ndarray
    a3: jnp.ndarray
    b3: jnp.ndarray
    c3: jnp.ndarray
    min_radius: float = 2.5
    max_radius: float = 60.0
    last_ir_band: int | None = None

    @classmethod
    def from_arrays(cls, radii, band_lims, a, b, c, min_radius=None,
                    max_radius=None):
        """Build from (3, nbins, nbands) a/b/c stacks (test fixture)."""
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        c = np.asarray(c, np.float32)
        radii = np.asarray(radii, np.float64)
        return cls(
            radii=radii, band_lims=np.asarray(band_lims, np.float64),
            a1=jnp.asarray(a[0]), b1=jnp.asarray(b[0]), c1=jnp.asarray(c[0]),
            a2=jnp.asarray(a[1]), b2=jnp.asarray(b[1]), c2=jnp.asarray(c[1]),
            a3=jnp.asarray(a[2]), b3=jnp.asarray(b[2]), c3=jnp.asarray(c[2]),
            min_radius=float(radii[0] if min_radius is None else min_radius),
            max_radius=float(radii[-1] if max_radius is None else max_radius))

    @classmethod
    def from_netcdf(cls, path: str):
        """Load a Hu & Stamnes coefficient file (construct_liquid_optics,
        liquid_cloud_optics.c:35-73): radius bin bounds from the `bounds`
        attribute's dataset, valid range from `valid_range`, coefficient
        variables a1..c3 on (radius, band)."""
        from ..utils.ncio import Dataset

        with Dataset(path) as nc:
            bounds_var = nc.attr("radius", "bounds")
            valid = np.asarray(nc.attr("radius", "valid_range"), np.float64)
            rb = nc.var(bounds_var)                       # (nbins, 2)
            radii = np.concatenate([rb[:, 0], rb[-1:, 1]])
            nbins = rb.shape[0]
            band_lims = nc.var("band_bnds").reshape(-1, 2).T  # (2, nbands)
            nbands = band_lims.shape[1]
            try:
                last_ir = int(np.asarray(nc.attr("band_bnds",
                                                 "last_IR_band")).item())
            except KeyError:
                last_ir = None

            def tab(name):
                return jnp.asarray(
                    nc.var(name).reshape(nbins, nbands), jnp.float32)

            return cls(radii=radii, band_lims=band_lims,
                       a1=tab("a1"), b1=tab("b1"), c1=tab("c1"),
                       a2=tab("a2"), b2=tab("b2"), c2=tab("c2"),
                       a3=tab("a3"), b3=tab("b3"), c3=tab("c3"),
                       min_radius=float(valid[0]), max_radius=float(valid[1]),
                       last_ir_band=last_ir)

    @property
    def num_bands(self) -> int:
        return self.a1.shape[1]

    def evaluate(self, water_concentration, equivalent_radius):
        """Per-band optics for batched layers.

        Args:
          water_concentration: (...,) liquid water content [g m-3].
          equivalent_radius: (...,) droplet equivalent radius [microns].

        Returns (extinction [1/km], single_scatter_albedo, asymmetry),
        each (..., num_bands) — same contract as PadeCloudOptics.evaluate.
        """
        wc = jnp.asarray(water_concentration, jnp.float32)[..., None]
        r = jnp.clip(jnp.asarray(equivalent_radius, jnp.float32),
                     self.min_radius, self.max_radius)
        # Bin index: last bin whose lower edge <= r (liquid_cloud_optics.c:
        # 18-24 break-on-greater loop == searchsorted right - 1 on edges).
        edges = jnp.asarray(self.radii[1:-1], jnp.float32)
        i = jnp.searchsorted(edges, r, side="right")
        r = r[..., None]

        def fit(a, b, c):
            return a[i] * r ** b[i] + c[i]

        ext = wc * _M_TO_KM * fit(self.a1, self.b1, self.c1)
        ssa = 1.0 - fit(self.a2, self.b2, self.c2)
        g = fit(self.a3, self.b3, self.c3)
        return ext, ssa, g
