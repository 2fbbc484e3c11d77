"""Per-layer spectral line preparation as batched jnp ops.

Re-expresses the reference's per-(layer, line) prep kernels
(gas-optics/src/kernels.c:34-131: calc_line_centers, calc_partition_functions,
calc_line_strengths, calc_lorentz_hw, calc_doppler_hw) as vectorized array
math over a (nlayers, nlines) plane.

Precision design (float32-safe): absolute line positions are never
held in float32.  At grid-bind time each line's center is split on the host in
float64 into an integer grid index ``c0`` and a fractional offset ``frac0``
(grid units); the device then tracks only the small pressure-shift correction,
so wavenumber offsets from line center are exact to float32 epsilon even at
50000 cm-1 — something neither the CUDA nor the OpenMP reference path needed
to worry about in double precision.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .. import constants
from . import molecules as mol_registry
from . import tips as tips_mod
from .hitran import LineCatalog
from ..spectral import SpectralGrid


@dataclasses.dataclass
class GridLines:
    """A line catalog bound to a spectral grid (host-side, numpy).

    ``c0``/``frac0`` encode the unshifted line center as
    ``(vnn - w0)/dw = c0 + frac0`` with ``|frac0| <= 0.5``.
    """

    mol_id: int
    mass_g: float
    num_iso: int
    c0: np.ndarray       # (L,) int32
    frac0: np.ndarray    # (L,) float32
    vnn: np.ndarray      # (L,) float32 (only used in strength/doppler factors)
    snn: np.ndarray      # (L,) float32 renormalized strength * 1e20
    yair: np.ndarray
    yself: np.ndarray
    en: np.ndarray
    n: np.ndarray
    d: np.ndarray        # pressure shift [cm-1 atm-1]
    iso0: np.ndarray     # (L,) int32 0-based isotopologue index (clipped)

    @property
    def num_lines(self) -> int:
        return int(self.c0.shape[0])

    def pad_to(self, L: int) -> "GridLines":
        """Pad with zero-strength sentinel lines to a static size."""
        pad = L - self.num_lines
        if pad < 0:
            raise ValueError("pad_to smaller than catalog")
        if pad == 0:
            return self

        def pz(a, val=0):
            return np.concatenate([a, np.full(pad, val, dtype=a.dtype)])

        # Sentinel center +1e9 is out of every grid (so the validity test
        # rejects it) and keeps ``c0`` sorted for tile bucketing.
        return GridLines(
            self.mol_id, self.mass_g, self.num_iso,
            pz(self.c0, 10 ** 9), pz(self.frac0), pz(self.vnn, 1.0),
            pz(self.snn), pz(self.yair, 1e-3), pz(self.yself, 1e-3),
            pz(self.en), pz(self.n), pz(self.d), pz(self.iso0),
        )


def bind_to_grid(catalog: LineCatalog, grid: SpectralGrid) -> GridLines:
    """Split float64 line centers into (int index, float32 fraction).

    Lines are sorted by center (the reference sorts per layer on device,
    kernels.c:135-173; centers shift by at most ~|d|*p so a host sort by
    unshifted center gives the same locality)."""
    mol = mol_registry.get(catalog.mol_id)
    order = np.argsort(catalog.vnn, kind="stable")
    vnn = catalog.vnn[order]
    pos = (vnn - grid.w0) / grid.dw  # float64
    c0 = np.floor(pos + 0.5).astype(np.int64)
    frac0 = (pos - c0).astype(np.float32)
    num_iso = max(mol.num_isotopologues, 1)
    iso0 = np.clip(catalog.iso[order].astype(np.int32) - 1, 0, num_iso - 1)
    return GridLines(
        mol_id=int(catalog.mol_id), mass_g=mol.mass_g, num_iso=num_iso,
        c0=c0.astype(np.int32), frac0=frac0,
        vnn=vnn.astype(np.float32),
        snn=catalog.snn[order].astype(np.float32),
        yair=catalog.yair[order], yself=catalog.yself[order],
        en=catalog.en[order], n=catalog.n[order], d=catalog.d[order],
        iso0=iso0,
    )


@dataclasses.dataclass
class LineTiles:
    """Host-precomputed spectral-tile -> line-list mapping.

    Re-architecture of the reference's line->grid scatter
    (omp atomic / atomicAdd, kernels.c:410-465, cuda_kernels.c:37-50):
    the scatter is inverted into per-tile *gathers* — tile t sums the Voigt
    contributions of the (padded, static-size) list of lines whose
    +-cutoff windows can touch grid points [t*tile, (t+1)*tile).  This is
    the bin-sweep structure (kernels.c:177-304) recast with dense masked
    reductions instead of bracketing loops.
    """

    tile: int                 # grid points per tile
    fsteps: int               # half-window in grid points
    tile_lines: np.ndarray    # (ntiles, lmax) int32 line indices, -1 = pad

    @property
    def ntiles(self) -> int:
        return int(self.tile_lines.shape[0])

    @property
    def lmax(self) -> int:
        return int(self.tile_lines.shape[1])


_X_FAR_SAFE = 13.0  # > sqrt(164): beyond every region-1 lower bound

_PMAX_ATM = 1.5  # generous pressure ceiling for shift-margin sizing


def shift_margin(lines: GridLines, dw: float) -> int:
    """Grid-point margin covering the largest possible pressure-induced
    center rounding drift: |adj| = |floor(frac0 + shift + 0.5)| <=
    ceil(|shift| + 0.5) for |frac0| <= 0.5, with shift = d * p / dw
    (kernels.c:34-48).  Sized for any physical pressure so host-built
    tile/window tables stay valid."""
    if lines.num_lines == 0:
        return 1
    dmax = float(np.max(np.abs(lines.d)))
    return max(1, int(np.ceil(dmax * _PMAX_ATM / dw + 0.5)))


def _x_threshold_halfwidth(lines: GridLines, dw: float, x_min: float,
                           tmax: float) -> int:
    """Grid-point half-width guaranteeing |x| >= x_min outside it.

    |x| = |dv| / (vnn sqrt(2 k T / m c^2)) >= x_min for all T <= tmax
    whenever |dv| >= x_min * vmax * sqrt(2 k tmax / m c^2); tmax = 500 K
    is the reference's physical-range guard (grtcode_config.h:70-99).
    """
    from .. import constants as c
    if lines.num_lines == 0:
        return 1
    vmax = float(np.max(np.abs(lines.vnn))) + 1.0
    mc2 = lines.mass_g * c.C_CGS * c.C_CGS
    dv = x_min * vmax * np.sqrt(2.0 * c.KB_CGS * tmax / mc2)
    return max(int(np.ceil(dv / dw)) + 1, 1)


def near_core_halfwidth(lines: GridLines, dw: float,
                        tmax: float = 500.0) -> int:
    """Half-width [grid points] of the near-core window outside which the
    cheap far-wing Voigt (regions 0/1) is exact for every line and layer
    (|x| >= 13 > sqrt(164), above every region-1 lower bound)."""
    return _x_threshold_halfwidth(lines, dw, _X_FAR_SAFE, tmax)


# max over y of xlim0 = 15100 + y (40 - 3.6 y) is 15211.1 at y = 5.56
# (RFM_voigt.c:103); sqrt = 123.33, so |x| >= 124 is region 0 for every y.
_X_REGION0_SAFE = 124.0


def region0_halfwidth(lines: GridLines, dw: float,
                      tmax: float = 500.0) -> int:
    """Half-width [grid points] outside which every point is Humlicek
    REGION 0 (pure rational y/sqrt(pi)/(x^2+y^2)) for every line, layer,
    and physical temperature — lets the far-wing kernel drop the
    region-0/1 select entirely."""
    return _x_threshold_halfwidth(lines, dw, _X_REGION0_SAFE, tmax)


@dataclasses.dataclass
class PointRanges:
    """Per-grid-point contiguous line ranges for the near-core pass.

    Sorted line centers mean the lines within +-near of any grid point
    form a contiguous index range [lo, hi) — so the near-core scatter
    inverts into a dense gather with a static K-wide reduction per point
    (no scatter, no per-point index lists).
    """

    near: int           # half-width [grid points] the ranges cover
    kpad: int           # max(hi - lo) padded to a lane multiple
    lo: np.ndarray      # (num_wpoints,) int32
    hi: np.ndarray      # (num_wpoints,) int32


def build_point_ranges(lines: GridLines, num_wpoints: int, near: int,
                       shift_margin: int = 2,
                       lane_multiple: int = 8) -> PointRanges:
    """Contiguous [lo, hi) line ranges per grid point covering centers in
    [g - near - margin, g + near + margin]."""
    g = np.arange(num_wpoints)
    reach = near + shift_margin
    lo = np.searchsorted(lines.c0, g - reach, side="left")
    hi = np.searchsorted(lines.c0, g + reach, side="right")
    kmax = int(np.max(hi - lo)) if num_wpoints else 0
    kpad = max(-(-max(kmax, 1) // lane_multiple) * lane_multiple,
               lane_multiple)
    return PointRanges(near=near, kpad=kpad, lo=lo.astype(np.int32),
                       hi=hi.astype(np.int32))


def build_tiles(lines: GridLines, num_wpoints: int, fsteps: int,
                tile: int = 512, shift_margin: int = 2,
                lane_multiple: int = 8) -> LineTiles:
    """Bucket grid-bound (sorted) lines into overlapping spectral tiles.

    ``shift_margin`` covers pressure-induced center drift (|d| * p is well
    under one grid point for HITRAN shifts at <= a few atm; 2 points is
    generous).  Per-tile lists are padded to a common multiple-of-
    ``lane_multiple`` length with -1.
    """
    ntiles = -(-num_wpoints // tile)
    reach = fsteps + shift_margin
    c0 = lines.c0
    # Sorted centers -> contiguous [lo, hi) index range per tile.
    lo = np.searchsorted(c0, np.arange(ntiles) * tile - reach, side="left")
    hi = np.searchsorted(c0, np.arange(ntiles) * tile + (tile - 1) + reach,
                         side="right")
    counts = hi - lo
    lmax = max(int(counts.max()) if counts.size else 0, 1)
    lmax = -(-lmax // lane_multiple) * lane_multiple
    tile_lines = np.full((ntiles, lmax), -1, dtype=np.int32)
    for t in range(ntiles):
        tile_lines[t, :counts[t]] = np.arange(lo[t], hi[t], dtype=np.int32)
    return LineTiles(tile=tile, fsteps=fsteps, tile_lines=tile_lines)


@dataclasses.dataclass
class PreparedLines:
    """Per-(layer, line) device arrays ready for Voigt accumulation."""

    center_idx: jnp.ndarray   # (nlayers, L) int32 nearest grid index
    center_frac: jnp.ndarray  # (nlayers, L) f32 fractional grid offset
    strength: jnp.ndarray     # (nlayers, L) f32, scaled by 1e20
    lorentz: jnp.ndarray      # (nlayers, L) f32 HWHM [cm-1]
    doppler: jnp.ndarray      # (nlayers, L) f32 HWHM*sqrt(ln2)-convention


def prepare(lines: GridLines, grid: SpectralGrid, pavg, tavg, psavg,
            tips=None) -> PreparedLines:
    """Line prep (kernels.c:34-131) for one molecule over all layers.

    Args:
      lines: grid-bound catalog.
      pavg, tavg: layer pressure [atm] / temperature [K], shape (nlayers,).
      psavg: layer partial pressure of this species [atm], (nlayers,).
      tips: partition-function provider (host-evaluated per layer).
    """
    if tips is None:
        tips = tips_mod.default_tips()
    c2 = constants.LINE_STRENGTH_C2
    tref = constants.TREF

    pavg = jnp.asarray(pavg, jnp.float32)[:, None]
    tavg = jnp.asarray(tavg, jnp.float32)[:, None]
    psavg = jnp.asarray(psavg, jnp.float32)[:, None]

    d = jnp.asarray(lines.d)
    frac0 = jnp.asarray(lines.frac0)
    c0 = jnp.asarray(lines.c0)

    # Pressure-shifted centers in split representation
    # (calc_line_centers, kernels.c:34-48: vnn = v0 + delta * p).
    shift = d * pavg / jnp.float32(grid.dw)          # (nlayers, L) grid units
    frac = frac0[None, :] + shift
    adj = jnp.floor(frac + 0.5)
    center_idx = c0[None, :] + adj.astype(jnp.int32)
    center_frac = frac - adj

    # Partition-function factors per (layer, iso), broadcast to lines
    # (calc_partition_functions, kernels.c:52-66).  The per-line isotopologue
    # pick is a select-sum over the (small, static) isotopologue count:
    # num_iso fused selects instead of a take_along_axis gather over the
    # (rows, L) plane, and exact.
    qinv = tips_mod.q_inverse_layers(
        tips, lines.mol_id, tavg[:, 0], lines.num_iso)
    qinv = qinv.astype(jnp.float32)                  # (nlayers, num_iso)
    iso0 = jnp.asarray(lines.iso0)[None, :]          # (1, L)
    qline = jnp.zeros((qinv.shape[0], lines.num_lines), jnp.float32)
    for i in range(lines.num_iso):
        qline = qline + jnp.where(iso0 == i, qinv[:, i:i + 1], 0.0)

    # Temperature-corrected strengths (kernels.c:70-89; uses the *unshifted*
    # center, see launch.c:117 passing line_params.vnn).
    en = jnp.asarray(lines.en)
    vnn0 = jnp.asarray(lines.vnn)
    s0 = jnp.asarray(lines.snn)
    strength = s0 * jnp.exp(c2 * en / tavg) * (1.0 - jnp.exp(c2 * vnn0 / tavg)) * qline

    # Lorentz half-widths (kernels.c:93-110).
    yair = jnp.asarray(lines.yair)
    yself = jnp.asarray(lines.yself)
    nn = jnp.asarray(lines.n)
    lorentz = jnp.power(tref / tavg, nn) * (yair * (pavg - psavg) + yself * psavg)

    # Doppler half-widths (kernels.c:114-131) using the shifted center:
    # alpha = sqrt(ln2) * vnn * sqrt(2 k T / (m c^2)).
    vnn_shifted = vnn0 + d * pavg
    mc2 = jnp.float32(lines.mass_g) * constants.C_CGS * constants.C_CGS
    doppler = constants.SQRT_LN2 * vnn_shifted * jnp.sqrt(
        2.0 * constants.KB_CGS * tavg / mc2)

    return PreparedLines(center_idx, center_frac, strength,
                         lorentz.astype(jnp.float32), doppler.astype(jnp.float32))
