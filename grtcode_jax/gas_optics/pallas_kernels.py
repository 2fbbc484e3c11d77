"""Fused Voigt optical-depth kernel for the GPU (Pallas, Triton route).

The reference's hottest kernel scatters every line's +-cutoff window into
tau with ``atomicAdd`` (gas-optics/src/kernels.c:410-465, cuda_kernels.c).
This kernel computes the same accumulation output-stationary instead: one
Triton program owns a ``(tile points) x (rblock rows)`` block of tau, keeps
it in registers, and streams the lines that can reach it one at a time.
The jnp formulation in :mod:`grtcode_jax.gas_optics.optical_depth`
(accumulate_tiled + accumulate_near_pointwise) is the numerical ground
truth.

  * Lines are sorted by center, so the lines reaching tile t form one
    contiguous index range [lo_t, hi_t); programs share nothing and carry
    nothing between each other.
  * **Far wings** (|grid offset from line center| > near): Humlicek regions
    0/1 + pure-Lorentz.  The per-(line, row) factors that do not depend on
    the grid point are precomputed by XLA into a transposed (NCH, lines,
    rows) channel stack, so each line costs a few contiguous row-vector
    loads.  The host splits [lo_t, hi_t) into three zones
    (build_line_ranges):
      - *core-adjacent* [C, D): some line is within region0_hw of the tile
        -- full region-0/1 select + window/near masks;
      - *interior* [A, B) u [E, F): every line covers the whole tile, is
        beyond region0_hw (|x| >= 124, pure region 0 for every y,
        lines.region0_halfwidth) and cannot shift off the grid -- K =
        snum0 / (xq + yq) with NO masks.  This is the bulk of the work;
      - *edge* (the rest): pure region 0 + the window mask.
    The split only skips selects whose outcome is host-provably constant.
    The zones are added outside in (far lines first, core-adjacent last)
    so small wing terms are not rounded away after the large ones.
  * **Near core** (|offset| <= near): the full Humlicek region scheme
    (regions 0-4) at the 2*hw+1 offsets around each line's unshifted grid
    index c0, for the lines whose centers can land in the tile.  Each
    offset is one row vector, added to the accumulator's point c0 + offset
    with a one-hot multiply-add; the ~300-op regions 2-4 run only for
    offsets where some row needs them.  hw = near + the pressure-shift
    margin, so the |g - cidx| <= near mask is always covered.

Rows are the flattened (batch, layer) axis: batching columns makes the
kernel denser instead of replaying it under vmap.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import constants
from .hitran import STRENGTH_SCALE

_PI = 3.14159265358979323846
_RSQRPI = 0.56418958354775628694  # 1/sqrt(pi)

# 6-term CPF expansion coefficients (RFM_voigt.c:156-161).
_C6 = (1.0117281, -0.75197147, 0.012557727, 0.010022008, -0.00024206814,
       0.00000050084806)
_S6 = (1.393237, 0.23115241, -0.15535147, 0.0062183662, 0.000091908299,
       -0.00000062752596)
_T6 = (0.31424038, 0.94778839, 1.5976826, 2.2795071, 3.0206370, 3.8897249)

# Channel indices in the (NCH, L, R) stack.
NCH = 6
CH_FTOT, CH_RW, CH_SNUM0, CH_YQ, CH_XLIM0, CH_Y = range(NCH)

# ftot of a line whose shifted center is off the grid for that row: every
# window and near mask then fails.
_INVALID = 1e9
# Pad values keep padded rows inert and division-safe.
_PAD_VALS = (_INVALID, 1.0, 0.0, 1.0, -1.0, 1.0)

# Rows of the per-tile line-range table (build_line_ranges).
NTAB = 10
T_LO, T_A, T_B, T_C, T_D, T_E, T_F, T_HI, T_NL, T_NH = range(NTAB)

# Program shape, from a sweep on an H100 at the RFMIP width (PERF.md).
RBLOCK = 32     # rows per program
NUM_WARPS = 4


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def far_channels(prep, c0, ns, *, dw: float, num_global: int, rpad: int):
    """Precompute the (NCH, L, rpad) channel stack (XLA, fused).

    Args:
      prep: PreparedLines with (rows, L) arrays.
      c0: (L,) int32 unshifted nearest grid index (GridLines.c0).
      ns: (rows,) species column density.

    The math mirrors :func:`grtcode_jax.gas_optics.voigt.voigt_far_wing`:
    Humlicek regions 0/1 with the pure-Lorentz limit folded in by forcing
    region 0 (xlim0 = -1) and substituting the unclamped y.  CH_FTOT is
    the unrounded shifted center relative to c0 (grid units); CH_Y is the
    clamped y the near core needs.
    """
    center_idx, center_frac = prep.center_idx, prep.center_frac
    strength, lorentz, doppler = prep.strength, prep.lorentz, prep.doppler
    rows = strength.shape[0]
    s = strength * (jnp.asarray(ns, jnp.float32) / STRENGTH_SCALE)[:, None]
    repwid = jnp.float32(constants.SQRT_LN2) / doppler
    y_true = repwid * lorentz
    lor = y_true >= 70.55
    y = jnp.minimum(y_true, 70.0)
    yq = y * y
    c_scale = jnp.float32(constants.RSQRPI * constants.RSQRPI) * repwid
    snum0 = s * jnp.where(lor, repwid * y_true / _PI, c_scale * y)
    yq_ch = jnp.where(lor, y_true * y_true, yq)
    xlim0 = jnp.where(lor, -1.0, 15100.0 + y * (40.0 - y * 3.6))
    valid = (center_idx >= 0) & (center_idx < num_global)
    # The rounding adjustment center_idx - c0 is a small integer, exact in
    # f32.
    adj = center_idx - jnp.asarray(c0, jnp.int32)[None, :]
    ftot = jnp.where(valid, center_frac + adj.astype(jnp.float32), _INVALID)
    rw = jnp.float32(dw) * repwid

    chans = (ftot, rw, snum0, yq_ch, xlim0, y)
    out = [jnp.pad(ch, ((0, rpad - rows), (0, 0)), constant_values=pad).T
           for ch, pad in zip(chans, _PAD_VALS)]
    return jnp.stack(out)                      # (NCH, L, rpad)


def _humlicek_y_coeffs(y, yq, xlim0):
    """Per-line (xi-independent) Humlicek region coefficients
    (RFM_voigt.c:108-277), hoisted out of the near-window offset loop."""
    xlim1 = jnp.where(y >= 8.425, 0.0,
                      jnp.sqrt(jnp.maximum(164.0 - y * (4.3 + y * 1.8),
                                           0.0)))
    xlim2 = 6.8 - y
    xlim3 = 2.4 * y
    xlim4 = 18.1 * y + 1.65
    tiny_y = y <= 0.000001
    xlim0_s = jnp.sqrt(jnp.maximum(xlim0, 0.0))
    xlim1 = jnp.where(tiny_y, xlim0_s, xlim1)
    xlim2 = jnp.where(tiny_y, xlim0_s, xlim2)

    h0 = 0.5625 + yq * (4.5 + yq * (10.5 + yq * (6.0 + yq)))
    h2 = -4.5 + yq * (9.0 + yq * (6.0 + yq * 4.0))
    h4 = 10.5 - yq * (6.0 - yq * 6.0)
    h6 = -6.0 + yq * 4.0
    e0 = 1.875 + yq * (8.25 + yq * (5.5 + yq))
    e2 = 5.25 + yq * (1.0 + yq * 3.0)
    e4 = 0.75 * h6

    z0 = 272.1014 + y * (1280.829 + y * (2802.870 + y * (3764.966
         + y * (3447.629 + y * (2256.981 + y * (1074.409 + y * (369.1989
         + y * (88.26741 + y * (13.39880 + y)))))))))
    z2 = 211.678 + y * (902.3066 + y * (1758.336 + y * (2037.310
         + y * (1549.675 + y * (793.4273 + y * (266.2987
         + y * (53.59518 + y * 5.0)))))))
    z4 = 78.86585 + y * (308.1852 + y * (497.3014 + y * (479.2576
         + y * (269.2916 + y * (80.39278 + y * 10.0)))))
    z6 = 22.03523 + y * (55.02933 + y * (92.75679 + y * (53.59518
         + y * 10.0)))
    z8 = 1.496460 + y * (13.39880 + y * 5.0)
    p0 = 153.5168 + y * (549.3954 + y * (919.4955 + y * (946.8970
         + y * (662.8097 + y * (328.2151 + y * (115.3772 + y * (27.93941
         + y * (4.264678 + y * 0.3183291))))))))
    p2 = -34.16955 + y * (-1.322256 + y * (124.5975 + y * (189.7730
         + y * (139.4665 + y * (56.81652 + y * (12.79458
         + y * 1.2733163))))))
    p4 = 2.584042 + y * (10.46332 + y * (24.01655 + y * (29.81482
         + y * (12.79568 + y * 1.9099744))))
    p6 = -0.07272979 + y * (0.9377051 + y * (4.266322 + y * 1.273316))
    p8 = 0.0005480304 + y * 0.3183291

    ypy0 = y + 1.5
    ypy0q = ypy0 * ypy0
    yf = y + 3.0
    return (xlim0_s, xlim1, xlim2, xlim3, xlim4, h0, h2, h4, h6, e0, e2,
            e4, z0, z2, z4, z6, z8, p0, p2, p4, p6, p8, ypy0, ypy0q, yf)


def _humlicek_eval(xi, xq, y, yq, a0, d0, d2, coeffs):
    """Full RFM Humlicek region scheme K(x, y) given hoisted coefficients.

    Matches grtcode_jax.gas_optics.voigt.humlicek_k for y < 70.55; callers
    handle the pure-Lorentz limit separately.
    """
    (xlim0_s, xlim1, xlim2, xlim3, xlim4, h0, h2, h4, h6, e0, e2, e4,
     z0, z2, z4, z6, z8, p0, p2, p4, p6, p8, ypy0, ypy0q, yf) = coeffs
    abx = jnp.abs(xi)

    k0 = y * _RSQRPI / (xq + yq)
    k1 = (_RSQRPI / (d0 + xq * (d2 + xq))) * y * (a0 + xq)
    k2 = (_RSQRPI / (h0 + xq * (h2 + xq * (h4 + xq * (h6 + xq))))) * \
        y * (e0 + xq * (e2 + xq * (e4 + xq)))
    k3 = (1.7724538 / (z0 + xq * (z2 + xq * (z4 + xq * (z6
          + xq * (z8 + xq)))))) * \
        (p0 + xq * (p2 + xq * (p4 + xq * (p6 + xq * p8))))

    k4a = jnp.zeros_like(xi)
    k4b = jnp.zeros_like(xi)
    for j in range(6):
        d = xi - _T6[j]
        mq = d * d
        mf = 1.0 / (mq + ypy0q)
        xm = mf * d
        ym = mf * ypy0
        dp = xi + _T6[j]
        pq = dp * dp
        pf = 1.0 / (pq + ypy0q)
        xp = pf * dp
        yp = pf * ypy0
        k4a = k4a + _C6[j] * (ym + yp) - _S6[j] * (xm - xp)
        k4b = k4b + (
            (_C6[j] * (mq * mf - 1.5 * ym) + _S6[j] * yf * xm)
            / (mq + 2.25)
            + (_C6[j] * (pq * pf - 1.5 * yp) - _S6[j] * yf * xp)
            / (pq + 2.25)
        )
    k4b = y * k4b + jnp.exp(-xq)
    k4 = jnp.where(abx <= xlim4, k4a, k4b)

    return jnp.where(
        abx >= xlim0_s, k0,
        jnp.where(abx >= xlim1, k1,
                  jnp.where(abx >= xlim2, k2,
                            jnp.where(abx < xlim3, k3, k4))))


def _voigt_kernel(tab_ref, c0_ref, scal_ref, chan_ref, out_ref, *,
                  tile: int, rblock: int, fsteps: int, hw: int,
                  num_global: int, include_near: bool):
    t = pl.program_id(0)
    rows = pl.ds(pl.program_id(1) * rblock, rblock)
    g0 = scal_ref[0] + t * tile            # global index of point 0
    nr = scal_ref[1].astype(jnp.float32)   # near-core half-width
    fs = jnp.float32(fsteps)
    # Point positions as an exact-integer f32 column.
    pts = jax.lax.broadcasted_iota(jnp.int32, (tile, 1), 0).astype(
        jnp.float32)

    def bound(k):
        return tab_ref[k, t]

    def chan(k, l):
        return chan_ref[k, pl.ds(l, 1), rows]          # (1, rblock)

    def far_body(mode):
        def body(l, acc):
            # dcol = g - c0 (exact integers); ftot = shifted center - c0.
            dcol = pts + (g0 - c0_ref[l]).astype(jnp.float32)  # (tile, 1)
            ftot = chan(CH_FTOT, l)
            snum0 = chan(CH_SNUM0, l)
            yq = chan(CH_YQ, l)
            xi = (dcol - ftot) * chan(CH_RW, l)            # (tile, rblock)
            xq = xi * xi
            if mode == "interior":
                return acc + snum0 / (xq + yq)
            adelta = jnp.abs(dcol - jnp.floor(ftot + 0.5))   # |g - cidx|
            if mode == "edge":
                return acc + jnp.where(adelta <= fs, snum0 / (xq + yq), 0.0)
            a0 = yq + 0.5
            reg0 = xq >= chan(CH_XLIM0, l)
            num = jnp.where(reg0, snum0, snum0 * (a0 + xq))
            den = jnp.where(reg0, xq + yq,
                            a0 * a0 + xq * (yq + yq - 1.0 + xq))
            m = (adelta <= fs) & (adelta > nr)
            return acc + jnp.where(m, num / den, 0.0)
        return body

    def near_body(l, acc):
        c0l = c0_ref[l]
        ftot = chan(CH_FTOT, l)
        rw = chan(CH_RW, l)
        snum0 = chan(CH_SNUM0, l)
        yq = chan(CH_YQ, l)
        xlim0 = chan(CH_XLIM0, l)
        y = chan(CH_Y, l)
        adj = jnp.floor(ftot + 0.5)
        valid = ftot < 0.5 * _INVALID
        lor = xlim0 < 0.0
        a0 = yq + 0.5
        d0 = a0 * a0
        d2 = yq + yq - 1.0
        # snum0 = s*RSQRPI^2*repwid*y for non-Lorentz lines, so the
        # full-Voigt prefactor s*RSQRPI*repwid = snum0/(RSQRPI*y).
        sfac = snum0 / (jnp.float32(_RSQRPI) * jnp.maximum(y, 1e-30))
        coeffs = _humlicek_y_coeffs(y, yq, xlim0)
        xlim0_s = coeffs[0]
        # |x| >= sqrt(164) is Humlicek region 0/1 for every y (xlim1^2 <=
        # 164), except the tiny-y branch (y <= 1e-6 forces xlim1 = xlim2 =
        # xlim0_s: the CPF region reaches out to xlim0).
        tiny = y <= 0.000001
        base = c0l - g0                       # tile position of offset 0
        for o in range(2 * hw + 1):
            off = o - hw
            # In-window, near-core and global-bounds mask (the line_sample
            # kernel clamps e = min(center + fsteps, n - 1),
            # kernels.c:433-436).
            m = (jnp.abs(off - adj) <= nr) & valid & (c0l + off < num_global)
            xi = (off - ftot) * rw
            xq = xi * xi
            r0 = 1.0 / (xq + yq)
            k0 = (y * jnp.float32(_RSQRPI)) * r0
            k1 = (jnp.float32(_RSQRPI) / (d0 + xq * (d2 + xq))) * y * \
                (a0 + xq)
            cheap = jnp.where(lor, snum0 * r0,
                              sfac * jnp.where(jnp.abs(xi) >= xlim0_s,
                                               k0, k1))
            need = m & jnp.logical_not(lor) & ((xq < 164.1) | tiny)

            def full(xi=xi, xq=xq, need=need, cheap=cheap):
                k = _humlicek_eval(xi, xq, y, yq, a0, d0, d2, coeffs)
                return jnp.where(need, sfac * k, cheap)

            val = jax.lax.cond(
                jnp.max(jnp.where(need, 1.0, 0.0)) > 0.0, full,
                lambda cheap=cheap: cheap)
            val = jnp.where(m, val, 0.0)                  # (1, rblock)
            onehot = jnp.where(pts == (base + off).astype(jnp.float32),
                               1.0, 0.0)                  # (tile, 1)
            acc = acc + onehot * val
        return acc

    b = [bound(k) for k in range(NTAB)]
    acc = jnp.zeros((tile, rblock), jnp.float32)
    # Far zones outside in: the farthest lines of both sides first, the
    # core-adjacent zone last, each side walked towards the tile.  Adding
    # the many small far-wing terms before the large core terms keeps them
    # from being rounded away in the float32 accumulator (in sorted order
    # the sum ran ~1.7e-6 low against float64).
    for lo, hi, mode, descending in ((b[T_LO], b[T_A], "edge", False),
                                     (b[T_F], b[T_HI], "edge", True),
                                     (b[T_A], b[T_B], "interior", False),
                                     (b[T_E], b[T_F], "interior", True),
                                     (b[T_B], b[T_C], "edge", False),
                                     (b[T_D], b[T_E], "edge", True),
                                     (b[T_C], b[T_D], "core", False)):
        body = far_body(mode)
        if descending:
            body = (lambda i, a, f=body, lo=lo, hi=hi:
                    f(lo + hi - 1 - i, a))
        acc = jax.lax.fori_loop(lo, hi, body, acc)
    if include_near:
        acc = jax.lax.fori_loop(b[T_NL], b[T_NH], near_body, acc)
    out_ref[...] = acc.T


@functools.partial(
    jax.jit,
    static_argnames=("tile", "fsteps", "hw", "ntiles_block", "rpad",
                     "rblock", "num_global", "include_near", "interpret"))
def voigt_pallas(channels, c0, tables, start, near, *, tile: int,
                 fsteps: int, hw: int, ntiles_block: int, rpad: int,
                 num_global: int, rblock: int = RBLOCK,
                 include_near: bool = True, interpret: bool = False):
    """Run the fused Voigt kernel over ``ntiles_block`` spectral tiles.

    Args:
      channels: (NCH, L, rpad) from :func:`far_channels`.
      c0: (L,) int32 unshifted grid index per line.
      tables: (NTAB, ntiles_block) int32 line ranges of the block's tiles
        (:func:`build_line_ranges`).
      start: scalar int32 global grid index of the block's first point.
      near: scalar int32 near-core half-width.

    Returns (rpad, ntiles_block * tile) float32 tau.
    """
    kernel = functools.partial(
        _voigt_kernel, tile=tile, rblock=rblock, fsteps=fsteps, hw=hw,
        num_global=num_global, include_near=include_near)
    scal = jnp.stack([jnp.asarray(start, jnp.int32),
                      jnp.asarray(near, jnp.int32)])
    return pl.pallas_call(
        kernel,
        grid=(ntiles_block, rpad // rblock),
        out_specs=pl.BlockSpec((rblock, tile), lambda t, r: (r, t)),
        out_shape=jax.ShapeDtypeStruct((rpad, ntiles_block * tile),
                                       jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="voigt_fused",
    )(jnp.asarray(tables, jnp.int32), jnp.asarray(c0, jnp.int32), scal,
      channels)


@dataclasses.dataclass(frozen=True)
class LineRanges:
    """Per-tile line ranges for the fused kernel (host-precomputed).

    ``table`` is (NTAB, ntiles) int32 with rows T_LO..T_NH: the lines
    reaching tile t are [LO, HI), split as edge [LO, A), interior [A, B),
    edge [B, C), core-adjacent [C, D), edge [D, E), interior [E, F), edge
    [F, HI); [NL, NH) are the lines whose near core can touch the tile.
    """

    table: np.ndarray


def build_line_ranges(c0_sorted: np.ndarray, num_wpoints: int, fsteps: int,
                      tile: int, shift_margin: int = 2,
                      near_hw: int | None = None,
                      region0_hw: int | None = None) -> LineRanges:
    """Host-side per-tile line ranges and far-wing zones.

    Mirrors lines.build_tiles bucketing (kernels.c:177-304 bin structure)
    without materializing index lists.  ``region0_hw`` (from
    :func:`lines.region0_halfwidth`) enables the interior and edge zones;
    when None, every reaching line is core-adjacent (full select math).
    """
    c0_sorted = np.asarray(c0_sorted, np.int64)
    ntiles = -(-num_wpoints // tile)
    first = np.arange(ntiles, dtype=np.int64) * tile
    last = first + tile - 1

    def left(v):
        return np.searchsorted(c0_sorted, v, side="left")

    def right(v):
        return np.searchsorted(c0_sorted, v, side="right")

    reach = fsteps + shift_margin
    lo, hi = left(first - reach), right(last + reach)
    hw = fsteps if near_hw is None else near_hw
    nl, nh = left(first - hw), right(last + hw)
    if region0_hw is None:
        a = b = c = lo
        d = e = f = hi
    else:
        # Edge and interior lines skip the near-core exclusion mask, which
        # is only sound when every line beyond the core zone is also
        # beyond the near window: force region0_hw >= the near reach.
        reach0 = max(region0_hw, hw) + shift_margin
        c = np.clip(left(first - reach0), lo, hi)
        d = np.clip(right(last + reach0), c, hi)
        # Interior-left: the window covers the whole tile (c0 >= last -
        # fsteps + margin), strictly beyond reach0, and the shifted center
        # cannot leave the grid (c0 >= margin).  Interior-right mirrors it.
        a = np.clip(left(np.maximum(last - fsteps + shift_margin,
                                    shift_margin)), lo, c)
        b = np.clip(right(first - reach0 - 1), a, c)
        e = np.clip(left(last + 1 + reach0), d, hi)
        f = np.clip(right(np.minimum(first + fsteps - shift_margin,
                                     num_wpoints - 1 - shift_margin)), e, hi)
    table = np.stack([lo, a, b, c, d, e, f, hi, nl, nh]).astype(np.int32)
    return LineRanges(table)


def accumulate_voigt_pallas(prep, c0, ns, ranges: LineRanges, *,
                            num_wpoints: int, dw: float, fsteps: int,
                            near: int, hw: int, tile: int, num_global: int,
                            tau0=None, start=0, include_near: bool = True,
                            rblock: int = RBLOCK,
                            interpret: bool = False):
    """Fused near+far Voigt accumulation via the Pallas kernel.

    Semantically equal to ``accumulate_tiled(..., exclude_within=near,
    far_kernel=True)`` plus (when ``include_near``)
    ``accumulate_near_pointwise(...)``: the complete line_sample optical
    depth (kernels.c:410-465) partitioned at |g - cidx| == near.

    Args:
      prep: PreparedLines with (rows, L) arrays (rows = batch x layers).
      c0: (L,) int32 unshifted grid indices (GridLines.c0).
      ns: (rows,) species column density.
      ranges: global per-tile tables from :func:`build_line_ranges`.
      hw: static near-window half-width in grid points (the unroll
        length); ``near`` is passed to the kernel as a dynamic scalar.
      start: traced global index of the output block (tile-aligned).

    Returns (rows, num_wpoints) accumulated into ``tau0`` if given.
    """
    if tile & (tile - 1) or rblock & (rblock - 1):
        raise ValueError(f"tile {tile} and rblock {rblock} must be powers "
                         "of two")
    rows = prep.strength.shape[0]
    rpad = _round_up(rows, rblock)
    ntiles_block = -(-num_wpoints // tile)
    channels = far_channels(prep, c0, ns, dw=dw, num_global=num_global,
                            rpad=rpad)
    # The block's columns of the global table; tiles past the grid end get
    # empty ranges (zero-padded columns) so their output stays zero.
    start = jnp.asarray(start, jnp.int32)
    table = jnp.pad(jnp.asarray(ranges.table), ((0, 0), (0, ntiles_block)))
    table = jax.lax.dynamic_slice_in_dim(table, start // tile, ntiles_block,
                                         axis=1)
    tau = voigt_pallas(channels, c0, table, start, near, tile=tile,
                       fsteps=fsteps, hw=hw, ntiles_block=ntiles_block,
                       rpad=rpad, num_global=num_global, rblock=rblock,
                       include_near=include_near, interpret=interpret)
    tau = tau[:rows, :num_wpoints]
    return tau if tau0 is None else tau0 + tau
