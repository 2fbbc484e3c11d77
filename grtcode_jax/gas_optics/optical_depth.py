"""Line-by-line optical-depth accumulation (the hottest kernel).

Re-architecture of the reference's ``line_sample`` method
(gas-optics/src/kernels.c:410-465 and its CUDA twin cuda_kernels.c) — the
production method used by the driver (framework/src/driver.c:618).

The reference scatters each line's +-cutoff window into tau with
``omp atomic`` / ``atomicAdd``.  Here each line
evaluates its Voigt profile over a *static* window of ``2*fsteps+1`` grid
points and the windows are combined with one batched scatter-add
(``tau.at[idx].add``) per line chunk, which XLA lowers to a sorted
segmented reduction.  Lines stream through a ``lax.scan`` so peak memory is
``nlayers * chunk * window`` regardless of catalog size.

The fused GPU kernel for the same computation lives in
:mod:`grtcode_jax.gas_optics.pallas_kernels`; this module is the portable
path and the numerical ground truth.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from .. import constants
from .hitran import STRENGTH_SCALE
from .lines import PreparedLines
from .voigt import voigt_far_wing, voigt_line_shape


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(jax.jit,
         static_argnames=("num_wpoints", "dw", "fsteps", "chunk", "num_global"))
def accumulate_line_sample(center_idx, center_frac, strength, lorentz, doppler,
                           ns, *, num_wpoints: int, dw: float, fsteps: int,
                           chunk: int = 1024, tau0=None, start=0,
                           num_global: int | None = None):
    """Accumulate per-line Voigt contributions into tau.

    Args:
      center_idx: (nlayers, L) int32 nearest grid index of shifted center.
      center_frac: (nlayers, L) f32 fractional grid offset of center.
      strength: (nlayers, L) f32, scaled by STRENGTH_SCALE.
      lorentz, doppler: (nlayers, L) f32 half-widths [cm-1].
      ns: (nlayers,) species column density [cm-2].
      num_wpoints, dw: spectral grid size / resolution.
      fsteps: half-window in grid points (= ceil(cutoff/dw)).
      chunk: lines per scan step (static).
      tau0: optional (nlayers, num_wpoints) to accumulate into.
      start: first (global) grid index of the output block — traced; lets a
        spectral shard accumulate only its ``num_wpoints``-wide window.
      num_global: total grid size for the center-validity test
        (kernels.c:433 checks the *full*-grid bounds); defaults to
        ``num_wpoints`` (unsharded).

    Returns (nlayers, num_wpoints) optical depth for grid points
    ``[start, start + num_wpoints)``.
    """
    if num_global is None:
        num_global = num_wpoints
    nlayers, L = strength.shape
    Lp = _round_up(max(L, 1), chunk)
    pad = Lp - L
    if pad:
        center_idx = jnp.pad(center_idx, ((0, 0), (0, pad)),
                             constant_values=-(10 ** 9))
        center_frac = jnp.pad(center_frac, ((0, 0), (0, pad)))
        strength = jnp.pad(strength, ((0, 0), (0, pad)))
        lorentz = jnp.pad(lorentz, ((0, 0), (0, pad)), constant_values=1e-3)
        doppler = jnp.pad(doppler, ((0, 0), (0, pad)), constant_values=1e-3)

    nchunks = Lp // chunk
    # (nchunks, nlayers, chunk) so scan slices the leading axis.
    def to_chunks(a):
        return a.reshape(nlayers, nchunks, chunk).transpose(1, 0, 2)

    xs = tuple(to_chunks(a) for a in
               (center_idx, center_frac, strength, lorentz, doppler))

    offsets = jnp.arange(-fsteps, fsteps + 1, dtype=jnp.int32)  # (G,)
    offs_f = offsets.astype(jnp.float32)
    ns_scaled = (jnp.asarray(ns, jnp.float32) / STRENGTH_SCALE)[:, None, None]

    if tau0 is None:
        tau0 = jnp.zeros((nlayers, num_wpoints), jnp.float32)

    start = jnp.asarray(start, jnp.int32)

    def body(tau, args):
        cidx, cfrac, s, lor, dop = args                      # (nlayers, C)
        local = cidx - start                                 # block-local index
        f = local[..., None] + offsets[None, None, :]        # (nlayers, C, G)
        # Offset from line center, exact in f32 (split representation).
        dv = (offs_f[None, None, :] - cfrac[..., None]) * jnp.float32(dw)
        k = voigt_line_shape(dv, lor[..., None], dop[..., None])
        valid_center = (cidx >= 0) & (cidx < num_global)     # kernels.c:433
        in_bounds = (f >= 0) & (f < num_wpoints)
        vals = jnp.where(valid_center[..., None] & in_bounds,
                         s[..., None] * ns_scaled * k, 0.0)
        idx = jnp.clip(f, 0, num_wpoints - 1)
        tau = jax.vmap(lambda t, i, v: t.at[i].add(v))(
            tau, idx.reshape(nlayers, -1), vals.reshape(nlayers, -1))
        return tau, None

    tau, _ = jax.lax.scan(body, tau0, xs)
    return tau


@partial(jax.jit, static_argnames=("num_wpoints", "dw", "fsteps", "tile",
                                   "lchunk", "num_global", "exclude_within",
                                   "far_kernel"))
def accumulate_tiled(center_idx, center_frac, strength, lorentz, doppler,
                     ns, tile_lines, *, num_wpoints: int, dw: float,
                     fsteps: int, tile: int, lchunk: int = 128, tau0=None,
                     start=0, num_global: int | None = None,
                     exclude_within: int = -1, far_kernel: bool = False):
    """Tile-gather Voigt accumulation — the jnp production path.

    Inverts the reference's line->grid scatter (kernels.c:410-465 with
    omp atomic / atomicAdd) into per-tile gathers: spectral tile t sums the
    masked Voigt contributions of the host-precomputed line list
    ``tile_lines[t]`` over its ``tile`` grid points.  Dense elementwise +
    reduction only — no scatters (the scatter formulation materializes
    gigabytes of iota/select temporaries).

    Args mirror :func:`accumulate_line_sample`; additionally:
      tile_lines: (ntiles_global, lmax) int32 from
        :func:`grtcode_jax.gas_optics.lines.build_tiles`, -1 padded.
      tile: grid points per tile (static).
      lchunk: lines per inner reduction step (static; bounds the
        (nlayers, lchunk, tile) temp).
      start: global index of the output block; MUST be tile-aligned.
      exclude_within: when >= 0, zero contributions with |grid offset| <=
        this value (the near-core points a separate pass covers).
      far_kernel: evaluate with :func:`voigt_far_wing` (regions 0/1
        only) — valid when ``exclude_within`` guarantees |x| >= 12.81
        for every surviving point.

    Returns (nlayers, num_wpoints) optical depth for grid points
    [start, start + num_wpoints).
    """
    if num_global is None:
        num_global = num_wpoints
    nlayers, L = strength.shape
    ntiles_block = -(-num_wpoints // tile)
    lmax = tile_lines.shape[1]
    lmax_p = _round_up(lmax, lchunk)
    if lmax_p != lmax:
        tile_lines = jnp.pad(tile_lines, ((0, 0), (0, lmax_p - lmax)),
                             constant_values=-1)
    start = jnp.asarray(start, jnp.int32)

    # The block's rows of the global tile table.  Row indices are clipped
    # (a gather, not a slice: slice clamping would shift *every* row and
    # pair tiles with the wrong line lists); rows past the table cover
    # only grid points >= num_global, so their output is zeroed.
    ntiles_global = tile_lines.shape[0]
    row_idx = start // tile + jnp.arange(ntiles_block, dtype=jnp.int32)
    rows = jnp.take(tile_lines, jnp.clip(row_idx, 0, ntiles_global - 1),
                    axis=0)                             # (ntiles, lmax_p)
    row_valid = (row_idx >= 0) & (row_idx < ntiles_global)

    pts = jnp.arange(tile, dtype=jnp.int32)             # (T,)
    ns_scaled = (jnp.asarray(ns, jnp.float32) / STRENGTH_SCALE)[:, None, None]

    def one_tile(tile_i, row, valid_tile):
        g = start + tile_i * tile + pts                 # (T,) global indices

        def chunk_step(acc, line_idx):                  # line_idx: (lchunk,)
            valid = line_idx >= 0
            li = jnp.maximum(line_idx, 0)
            cidx = center_idx[:, li]                    # (nlayers, C)
            cfrac = center_frac[:, li]
            s = strength[:, li]
            lor = lorentz[:, li]
            dop = doppler[:, li]
            delta = g[None, None, :] - cidx[..., None]  # (nlayers, C, T) int
            dv = (delta.astype(jnp.float32) - cfrac[..., None]) * \
                jnp.float32(dw)
            shape_fn = voigt_far_wing if far_kernel else voigt_line_shape
            k = shape_fn(dv, lor[..., None], dop[..., None])
            mask = (jnp.abs(delta) <= fsteps) & \
                (cidx[..., None] >= 0) & (cidx[..., None] < num_global) & \
                valid[None, :, None]
            if exclude_within >= 0:
                mask = mask & (jnp.abs(delta) > exclude_within)
            contrib = jnp.where(mask, s[..., None] * ns_scaled * k, 0.0)
            return acc + contrib.sum(axis=1), None

        acc0 = jnp.zeros((nlayers, tile), jnp.float32)
        acc, _ = jax.lax.scan(chunk_step, acc0,
                              row.reshape(-1, lchunk))
        return jnp.where(valid_tile, acc, 0.0)          # (nlayers, T)

    tau_tiles = jax.lax.map(
        lambda args: one_tile(*args),
        (jnp.arange(ntiles_block, dtype=jnp.int32), rows, row_valid))
    tau = tau_tiles.transpose(1, 0, 2).reshape(nlayers, ntiles_block * tile)
    tau = tau[:, :num_wpoints]
    return tau if tau0 is None else tau0 + tau


@partial(jax.jit, static_argnames=("num_wpoints", "dw", "near", "kpad",
                                   "wchunk", "num_global"))
def accumulate_near_pointwise(center_idx, center_frac, strength, lorentz,
                              doppler, ns, point_lo, point_hi, *,
                              num_wpoints: int, dw: float, near: int,
                              kpad: int, wchunk: int = 4096, tau0=None,
                              start=0, num_global: int | None = None):
    """Near-core accumulation as a dense per-point gather.

    For each grid point, gather the contiguous (sorted) line range that
    can reach it (lines.build_point_ranges) and reduce over a static
    ``kpad``-wide axis with the full-region Voigt — no scatters.

    Covers exactly |grid offset| <= near, complementing the far-wing
    tiled pass's ``exclude_within=near``.

    Args beyond :func:`accumulate_line_sample`:
      point_lo / point_hi: (num_global,) int32 line ranges per point.
      kpad: static max range width.
      wchunk: grid points per scan step.
    """
    if num_global is None:
        num_global = num_wpoints
    nlayers, L = strength.shape
    nblocks = -(-num_wpoints // wchunk)
    start = jnp.asarray(start, jnp.int32)

    pad_n = nblocks * wchunk
    # Pad so every dynamic block slice is in bounds (empty ranges).
    point_lo = jnp.pad(point_lo, (0, pad_n), constant_values=0)
    point_hi = jnp.pad(point_hi, (0, pad_n), constant_values=0)

    ks = jnp.arange(kpad, dtype=jnp.int32)              # (K,)
    pts = jnp.arange(wchunk, dtype=jnp.int32)
    ns_scaled = (jnp.asarray(ns, jnp.float32) / STRENGTH_SCALE)[:, None, None]

    def one_block(b):
        g0 = start + b * wchunk
        g = g0 + pts                                    # (W,) global indices
        lo = jax.lax.dynamic_slice_in_dim(point_lo, g0, wchunk)
        hi = jax.lax.dynamic_slice_in_dim(point_hi, g0, wchunk)
        idx = jnp.minimum(lo[:, None] + ks[None, :], L - 1)   # (W, K)
        valid_k = (lo[:, None] + ks[None, :]) < hi[:, None]

        cidx = center_idx[:, idx]                       # (nlayers, W, K)
        cfrac = center_frac[:, idx]
        s = strength[:, idx]
        lor = lorentz[:, idx]
        dop = doppler[:, idx]
        delta = g[None, :, None] - cidx
        dv = (delta.astype(jnp.float32) - cfrac) * jnp.float32(dw)
        k = voigt_line_shape(dv, lor, dop)
        mask = valid_k[None, :, :] & (jnp.abs(delta) <= near) & \
            (cidx >= 0) & (cidx < num_global) & \
            (g[None, :, None] < num_global)
        return jnp.where(mask, s * ns_scaled * k, 0.0).sum(axis=-1)

    tau_blocks = jax.lax.map(one_block,
                             jnp.arange(nblocks, dtype=jnp.int32))
    tau = tau_blocks.transpose(1, 0, 2).reshape(nlayers, pad_n)
    tau = tau[:, :num_wpoints]
    return tau if tau0 is None else tau0 + tau


def optical_depth_line_sample(prep: PreparedLines, ns, grid, *,
                              cutoff: float = constants.DEFAULT_LINE_CUTOFF,
                              chunk: int = 1024, tau0=None, start=0,
                              block: int | None = None):
    """Convenience wrapper taking PreparedLines + SpectralGrid.

    ``start``/``block`` select a spectral sub-window (for sharded grids):
    the result covers grid points [start, start + block)."""
    fsteps = int(math.ceil(cutoff / grid.dw))
    return accumulate_line_sample(
        prep.center_idx, prep.center_frac, prep.strength, prep.lorentz,
        prep.doppler, ns, num_wpoints=grid.n if block is None else block,
        dw=float(grid.dw), fsteps=fsteps, chunk=chunk, tau0=tau0,
        start=start, num_global=grid.n)
