"""Spectral bins and the bin-interpolated optical-depth methods.

Re-design of the reference's ``wavenumber_sweep`` (bin_sweep) and
``line_sweep`` methods (gas-optics/src/kernels.c:177-304, 306-406) and the
supporting machinery:

  * ``SpectralBins`` mirrors create_spectral_bins
    (gas-optics/src/spectral_bin.c:30-108): the grid is partitioned into
    ~1 cm-1 bins; each bin carries NIP = 3 interpolation wavenumbers
    (first / midpoint / last fine point).
  * "Local" lines evaluate the full Voigt on the bin's fine grid points;
    "remote" lines evaluate only at the NIP points, accumulated into a
    coarse (layers, bins, NIP) buffer.
  * After ALL absorbers (including continua/CFC/CIA, which add straight
    to the fine tau — launch.c:211-218), the coarse wing buffer is
    quadratically interpolated onto the fine grid and clamped at zero
    (kernel_utils.c:79-104 bin_quad_interp).

The reference brackets lines per (layer, bin) on the pressure-SHIFTED,
per-layer-sorted centers (kernels.c:196-206).  Shifts are at most
|delta| * p ~ 0.01 cm-1, so this build brackets once on the host against
the unshifted centers with the same boundary semantics (including the C
``bracket``'s one-line overshoot on each side, kernel_utils.c:26-76);
lines within a shift of a bin boundary may be classed local/remote
differently from the reference — a physically negligible re-binning the
reference itself exhibits between layers.

The line -> bin scatter (omp atomic, kernels.c:355-399) is inverted into
per-bin gathers over host-precomputed contiguous line ranges — sorted
centers make every local/remote set per bin a pair of contiguous index
ranges, so no index lists and no atomics are needed.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .hitran import STRENGTH_SCALE
from .lines import GridLines, PreparedLines
from .voigt import voigt_line_shape

NIP = 3  # interpolation points per bin (spectral_bin-internal.h)


@dataclasses.dataclass
class SpectralBins:
    """Uniform spectral bins (spectral_bin.h:29-50)."""

    num_wpoints: int
    w0: float
    wres: float
    width: float
    ppb: int            # fine points per bin
    last_ppb: int
    n: int              # number of bins
    do_interp: bool
    do_last_interp: bool
    l: np.ndarray       # (n,) int64 leftmost fine index per bin
    r: np.ndarray       # (n,) rightmost fine index per bin
    w: np.ndarray       # (n, NIP) float64 interpolation wavenumbers


def create_spectral_bins(num_wpoints: int, w0: float, wres: float,
                         bin_width: float = 1.0) -> SpectralBins:
    """Mirror of create_spectral_bins (spectral_bin.c:30-108)."""
    ppb = int(np.floor(bin_width / wres)) + 1
    do_interp = ppb > 3
    last_ppb = num_wpoints % ppb
    last_ppb = ppb if last_ppb == 0 else last_ppb
    do_last_interp = last_ppb > 3
    n = num_wpoints // ppb
    if ppb != last_ppb:
        n += 1
    l = np.arange(n, dtype=np.int64) * ppb
    sizes = np.full(n, ppb, dtype=np.int64)
    sizes[-1] = last_ppb
    r = l + sizes - 1
    w = np.empty((n, NIP), dtype=np.float64)
    w[:, 0] = w0 + l * wres
    w[:, NIP - 1] = w[:, 0] + (sizes - 1) * wres
    w[:, 1] = 0.5 * (w[:, 0] + w[:, NIP - 1])
    return SpectralBins(num_wpoints=num_wpoints, w0=w0, wres=wres,
                        width=bin_width, ppb=ppb, last_ppb=last_ppb, n=n,
                        do_interp=do_interp, do_last_interp=do_last_interp,
                        l=l, r=r, w=w)


# ---------------------------------------------------------------------------
# Host-side bracketing (kernel_utils.c:26-76 semantics)
# ---------------------------------------------------------------------------

def _bracket_left(v: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """C bracket()'s *left* index: largest i with v[i] <= val (0 if val
    precedes everything); exact hits return the hit index."""
    i = np.searchsorted(v, vals, side="left")
    exact = (i < len(v)) & (np.take(v, np.minimum(i, len(v) - 1)) == vals)
    left = np.where(exact, i, i - 1)
    return np.clip(left, 0, max(len(v) - 1, 0))


def _bracket_right(v: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """C bracket()'s *right* index: smallest i with v[i] >= val (n-1 if
    val exceeds everything)."""
    i = np.searchsorted(v, vals, side="left")
    return np.clip(i, 0, max(len(v) - 1, 0))


@dataclasses.dataclass
class BinRanges:
    """Per-bin contiguous line index ranges for local + remote passes.

    Local: lines evaluated on the bin's fine points.  Remote: lines
    evaluated at the bin's NIP interpolation points (left and right of
    the local window are contiguous ranges on the sorted catalog).
    """

    local_lo: np.ndarray    # (nbins,)
    local_cnt: np.ndarray
    rem_lo: np.ndarray      # remote-left range
    rem_cnt_l: np.ndarray
    rem_hi_start: np.ndarray  # remote-right range start
    rem_cnt_r: np.ndarray
    lmax_local: int
    lmax_remote: int


def build_bin_ranges(lines: GridLines, bins: SpectralBins, *,
                     mode: str, nbin_local: int = 1, nbin_remote: int = 25,
                     local_cutoff: float = 1.5,
                     remote_cutoff: float = 25.0,
                     lane_multiple: int = 8) -> BinRanges:
    """Local/remote line ranges per bin.

    mode="bin_sweep": local = centers within [first point of bin
    j-nbin_local, last point of bin j+nbin_local] with the C bracket's
    one-line overshoot (kernels.c:196-227); remote extends nbin_remote
    bins each way.
    mode="line_sweep": local = centers within +-local_cutoff cm-1 of the
    bin (the reference's per-line bin walk, kernels.c:326-357, inverted);
    remote extends +-remote_cutoff cm-1.
    """
    # Unshifted line centers in wavenumber units (float64, host).
    v = (np.asarray(lines.c0, np.float64)
         + np.asarray(lines.frac0, np.float64)) * bins.wres + bins.w0
    nl = lines.num_lines
    j = np.arange(bins.n)
    if mode == "bin_sweep":
        jl = np.maximum(j - nbin_local, 0)
        jr = np.minimum(j + nbin_local, bins.n - 1)
        leftw = bins.w[jl, 0]
        rightw = bins.w[jr, NIP - 1]
        jlr = np.maximum(j - nbin_remote, 0)
        jrr = np.minimum(j + nbin_remote, bins.n - 1)
        leftw_r = bins.w[jlr, 0]
        rightw_r = bins.w[jrr, NIP - 1]
        # C bracket semantics: local = [bracket_left(leftw),
        # bracket_right(rightw)] inclusive (one-line overshoot each side).
        llo = _bracket_left(v, leftw)
        lhi = _bracket_right(v, rightw)
        # Bins with no overlap at all get empty ranges (kernels.c:203-236);
        # the leftw > v[-1] branch sets left = num_lines so the remote-left
        # range then covers through the last line (kernels.c:229-232).
        nonempty = (leftw <= v[-1]) & (rightw >= v[0]) if nl else \
            np.zeros(bins.n, bool)
        llo = np.where(leftw > (v[-1] if nl else -np.inf), nl, llo)
        rlo = _bracket_left(v, leftw_r)
        rhi = _bracket_right(v, rightw_r)
        ne_l = (leftw >= v[0]) & (leftw_r <= v[-1]) if nl else \
            np.zeros(bins.n, bool)
        ne_r = (rightw <= v[-1]) & (rightw_r >= v[0]) if nl else \
            np.zeros(bins.n, bool)
    elif mode == "line_sweep":
        # Inverted per-line bin walk: line touches bins
        # [floor((v - cutoff - w0)/bw), floor((v + cutoff - w0)/bw)]
        # (kernels.c:326-357), so bin j's local lines have
        # v in [start_j - cutoff, end_of_bin_width_j + cutoff).
        bw = bins.wres * bins.ppb
        start = bins.w0 + j * bw
        llo = np.searchsorted(v, start - local_cutoff, side="left")
        lhi = np.searchsorted(v, start + bw + local_cutoff, side="left") - 1
        rlo = np.searchsorted(v, start - remote_cutoff, side="left")
        rhi = np.searchsorted(v, start + bw + remote_cutoff, side="left") - 1
        nonempty = lhi >= llo
        ne_l = rlo < llo
        ne_r = rhi > lhi
    else:
        raise ValueError(mode)

    local_lo = np.where(nonempty, llo, 0).astype(np.int32)
    local_cnt = np.where(nonempty, lhi - llo + 1, 0).astype(np.int32)
    rem_lo = np.where(ne_l, rlo, 0).astype(np.int32)
    rem_cnt_l = np.where(ne_l, llo - rlo, 0).astype(np.int32)
    # Remote-right starts just past the local range.
    rhs = np.where(nonempty, lhi + 1, llo)
    rem_hi_start = np.where(ne_r, rhs, 0).astype(np.int32)
    rem_cnt_r = np.where(ne_r, rhi - rhs + 1, 0).astype(np.int32)
    rem_cnt_r = np.maximum(rem_cnt_r, 0)

    def pad(x):
        m = int(x.max(initial=0))
        return max(-(-max(m, 1) // lane_multiple) * lane_multiple,
                   lane_multiple)

    return BinRanges(local_lo=local_lo, local_cnt=local_cnt, rem_lo=rem_lo,
                     rem_cnt_l=rem_cnt_l, rem_hi_start=rem_hi_start,
                     rem_cnt_r=rem_cnt_r, lmax_local=pad(local_cnt),
                     lmax_remote=pad(np.maximum(rem_cnt_l, rem_cnt_r)))


# ---------------------------------------------------------------------------
# Device accumulation
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("ppb", "nbins", "lmax_local",
                                   "lmax_remote", "dw", "num_wpoints"))
def accumulate_bins(center_idx, center_frac, strength, lorentz, doppler, ns,
                    local_lo, local_cnt, rem_lo, rem_cnt_l, rem_hi_start,
                    rem_cnt_r, bin_l, bin_w_rel, *, ppb: int, nbins: int,
                    lmax_local: int, lmax_remote: int, dw: float,
                    num_wpoints: int, tau0=None, bins_tau0=None):
    """One molecule's bin-method accumulation.

    Args:
      center_idx..ns: PreparedLines arrays (rows, L) + (rows,) density.
      local_lo..rem_cnt_r: (nbins,) int32 host range tables.
      bin_l: (nbins,) int32 leftmost fine index per bin.
      bin_w_rel: (nbins, NIP) f32 interp positions in grid units.
      ppb: fine points per bin (static; last bin is masked).

    Returns (tau (rows, num_wpoints), bins_tau (rows, nbins, NIP)):
    fine-grid local contributions and coarse remote wing contributions.
    """
    rows, L = strength.shape
    ns_scaled = (jnp.asarray(ns, jnp.float32) / STRENGTH_SCALE)[:, None, None]
    lmax_pad = max(lmax_local, lmax_remote)
    pads = []
    for a, fill in ((center_idx, -10 ** 9), (center_frac, 0.0),
                    (strength, 0.0), (lorentz, 1e-3), (doppler, 1e-3)):
        pads.append(jnp.pad(a, ((0, 0), (0, lmax_pad)),
                            constant_values=fill))
    cidx_p, cfrac_p, s_p, lor_p, dop_p = pads

    def range_sum(lo, cnt, eval_pts, lmax):
        def slc(a):
            return jax.lax.dynamic_slice_in_dim(a, lo, lmax, axis=1)
        ks = jnp.arange(lmax, dtype=jnp.int32)
        valid = ks < cnt
        ci = slc(cidx_p)
        dv = (eval_pts[None, None, :]
              - ci[..., None].astype(jnp.float32)
              - slc(cfrac_p)[..., None]) * jnp.float32(dw)
        k = voigt_line_shape(dv, slc(lor_p)[..., None],
                             slc(dop_p)[..., None])
        contrib = jnp.where(valid[None, :, None],
                            slc(s_p)[..., None] * ns_scaled * k, 0.0)
        return contrib.sum(axis=1)                      # (rows, P)

    pts_local = jnp.arange(ppb, dtype=jnp.float32)      # offsets in bin

    def one_bin(args):
        (llo, lcnt, rlo, rcl, rhs, rcr, bl, wrel) = args
        base = bl.astype(jnp.float32)
        local = range_sum(llo, lcnt, base + pts_local, lmax_local)
        rem = range_sum(rlo, rcl, wrel, lmax_remote) + \
            range_sum(rhs, rcr, wrel, lmax_remote)
        return local, rem

    local_t, rem_t = jax.lax.map(
        one_bin, (local_lo, local_cnt, rem_lo, rem_cnt_l, rem_hi_start,
                  rem_cnt_r, jnp.asarray(bin_l, jnp.int32),
                  jnp.asarray(bin_w_rel, jnp.float32)))
    # local_t: (nbins, rows, ppb) -> (rows, nbins*ppb), trimmed; the last
    # bin's fine points past the grid end are dropped by the trim.
    tau = local_t.transpose(1, 0, 2).reshape(rows, nbins * ppb)
    tau = tau[:, :num_wpoints]
    bins_tau = rem_t.transpose(1, 0, 2)                 # (rows, nbins, NIP)
    if tau0 is not None:
        tau = tau0 + tau
    if bins_tau0 is not None:
        bins_tau = bins_tau0 + bins_tau
    return tau, bins_tau


@partial(jax.jit, static_argnames=("ppb", "last_ppb", "do_interp",
                                   "do_last_interp", "num_wpoints",
                                   "last_bin"))
def interpolate_bins(bins_tau, bin_l, bin_w_rel, *, ppb: int, last_ppb: int,
                     do_interp: bool, do_last_interp: bool,
                     num_wpoints: int, tau, bin0=0,
                     last_bin: int | None = None):
    """Quadratic bin-wing interpolation onto the fine grid
    (kernels.c:514-581, kernel_utils.c:79-117), added into ``tau``.

    bins_tau: (rows, nbins, NIP); bin_w_rel: (nbins, NIP) grid units.

    For a spectral BLOCK of bins, pass the block's rows of bins_tau /
    bin_l / bin_w_rel plus ``bin0`` (the block's first global bin index,
    may be traced) and ``last_bin`` (the band's global last bin index,
    static) so the last-bin interpolation switch lands on the right bin;
    ``tau`` / ``num_wpoints`` are then block-local.
    """
    rows, nbins, _ = bins_tau.shape
    if last_bin is None:
        last_bin = nbins - 1
    pts = jnp.arange(ppb, dtype=jnp.float32)            # (ppb,)
    wrel = jnp.asarray(bin_w_rel, jnp.float32)
    bl = jnp.asarray(bin_l, jnp.float32)
    # Per-bin fine positions (nbins, ppb), relative to x0 of the bin.
    p = (bl[:, None] + pts[None, :]) - wrel[:, 0:1]
    x1 = wrel[:, 1:2] - wrel[:, 0:1]
    x2 = wrel[:, 2:3] - wrel[:, 0:1]
    y0 = bins_tau[:, :, 0]
    y1 = bins_tau[:, :, 1]
    y2 = bins_tau[:, :, 2]

    def quad(p, y0, y1, y2):
        t = ((p - x1) * (p - x2) / (x1 * x2))[None] * y0[..., None] \
            + (p * (p - x2) / (x1 * (x1 - x2)))[None] * y1[..., None] \
            + (p * (p - x1) / (x2 * (x2 - x1)))[None] * y2[..., None]
        return jnp.maximum(t, 0.0)                      # (rows, nbins, ppb)

    def nearest(p, y0, y1, y2):
        # ppb <= 3: bin_no_interp copies bins.tau[k] to fine point k
        # verbatim (kernel_utils.c:108-117).
        k = jnp.clip(p.astype(jnp.int32), 0, NIP - 1)[None]  # (1, nbins, ppb)
        return jnp.where(k == 0, y0[..., None],
                         jnp.where(k == 1, y1[..., None], y2[..., None]))

    vals = quad(p, y0, y1, y2) if do_interp else nearest(p, y0, y1, y2)
    if do_interp != do_last_interp:
        last = (nearest if do_interp else quad)(p, y0, y1, y2)
        mask = jnp.asarray(bin0, jnp.int32) + jnp.arange(nbins) == last_bin
        vals = jnp.where(mask[None, :, None], last, vals)
    flat = vals.reshape(rows, nbins * ppb)[:, :num_wpoints]
    return tau + flat
