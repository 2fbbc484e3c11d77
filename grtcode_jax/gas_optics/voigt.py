"""Branch-free Voigt line shape (Humlicek / RFM "voishp" formulation).

Re-design of the reference rfm_voigt_line_shape
(gas-optics/src/RFM_voigt.c:85-281): the scalar per-point region branches
become elementwise ``jnp.where`` selects, so the whole (line, wavenumber)
plane evaluates as one vectorized elementwise computation with no data-dependent
control flow.  The algorithm is the JQSRT-1999 revision of Humlicek's W4
region scheme as used by the Reference Forward Model
(https://doi.org/10.1016/j.jqsrt.2016.06.018).

The reference evaluates this routine in float32 even in its double build
(all internal locals are ``float``); float32 is therefore the parity dtype.

Normalization: returns K such that the absorption cross-section contribution
is ``S * K`` with K = sqrt(ln2/pi)/alpha_d * K_humlicek(x, y),
x = sqrt(ln2) (v - v0)/alpha_d,  y = sqrt(ln2) alpha_l/alpha_d.
"""
from __future__ import annotations

import jax.numpy as jnp

from .. import constants

_PI = 3.14159265358979323846

# 6-term CPF expansion coefficients (RFM_voigt.c:156-161).
_C = (1.0117281, -0.75197147, 0.012557727, 0.010022008, -0.00024206814,
      0.00000050084806)
_S = (1.393237, 0.23115241, -0.15535147, 0.0062183662, 0.000091908299,
      -0.00000062752596)
_T = (0.31424038, 0.94778839, 1.5976826, 2.2795071, 3.0206370, 3.8897249)


def humlicek_k(xi, y):
    """Humlicek K(x, y) (the real part of the complex probability function
    scaled by 1/sqrt(pi) at the end by the caller).

    ``xi`` and ``y`` broadcast elementwise; ``y`` must be < 70.55 for the
    region scheme (the caller handles the pure-Lorentz limit).
    """
    yq = y * y
    abx = jnp.abs(xi)
    xq = abx * abx

    # Region limits (RFM_voigt.c:108-126).
    xlim0 = jnp.sqrt(15100.0 + y * (40.0 - y * 3.6))
    xlim1 = jnp.where(y >= 8.425, 0.0,
                      jnp.sqrt(jnp.maximum(164.0 - y * (4.3 + y * 1.8), 0.0)))
    xlim2 = 6.8 - y
    xlim3 = 2.4 * y
    xlim4 = 18.1 * y + 1.65
    tiny_y = y <= 0.000001
    xlim1 = jnp.where(tiny_y, xlim0, xlim1)
    xlim2 = jnp.where(tiny_y, xlim0, xlim2)

    yrrtpi = y * constants.RSQRPI

    # Region 0: |x| >= xlim0 — Lorentz wing.
    k0 = yrrtpi / (xq + yq)

    # Region 1: xlim1 <= |x| < xlim0 (RFM_voigt.c:172-183).
    a0 = yq + 0.5
    d0 = a0 * a0
    d2 = yq + yq - 1.0
    k1 = (constants.RSQRPI / (d0 + xq * (d2 + xq))) * y * (a0 + xq)

    # Region 2: xlim2 <= |x| < xlim1 (RFM_voigt.c:184-199).
    h0 = 0.5625 + yq * (4.5 + yq * (10.5 + yq * (6.0 + yq)))
    h2 = -4.5 + yq * (9.0 + yq * (6.0 + yq * 4.0))
    h4 = 10.5 - yq * (6.0 - yq * 6.0)
    h6 = -6.0 + yq * 4.0
    e0 = 1.875 + yq * (8.25 + yq * (5.5 + yq))
    e2 = 5.25 + yq * (1.0 + yq * 3.0)
    e4 = 0.75 * h6
    k2 = (constants.RSQRPI / (h0 + xq * (h2 + xq * (h4 + xq * (h6 + xq))))) * \
        y * (e0 + xq * (e2 + xq * (e4 + xq)))

    # Region 3: |x| < xlim3 (RFM_voigt.c:200-230).
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
    k3 = (1.7724538 / (z0 + xq * (z2 + xq * (z4 + xq * (z6 + xq * (z8 + xq)))))) * \
        (p0 + xq * (p2 + xq * (p4 + xq * (p6 + xq * p8))))

    # Region 4: xlim3 <= |x| < xlim2 — 6-term CPF (RFM_voigt.c:231-277).
    y0 = 1.5
    y0q = 2.25
    ypy0 = y + y0
    ypy0q = ypy0 * ypy0
    k4a = jnp.zeros_like(xi)
    k4b = jnp.zeros_like(xi)
    yf = y + 3.0  # Y + Y0PY0
    for j in range(6):
        d = xi - _T[j]
        mq = d * d
        mf = 1.0 / (mq + ypy0q)
        xm = mf * d
        ym = mf * ypy0
        dp = xi + _T[j]
        pq = dp * dp
        pf = 1.0 / (pq + ypy0q)
        xp = pf * dp
        yp = pf * ypy0
        k4a = k4a + _C[j] * (ym + yp) - _S[j] * (xm - xp)
        k4b = k4b + (
            (_C[j] * (mq * mf - y0 * ym) + _S[j] * yf * xm) / (mq + y0q)
            + (_C[j] * (pq * pf - y0 * yp) - _S[j] * yf * xp) / (pq + y0q)
        )
    k4b = y * k4b + jnp.exp(-xq)
    k4 = jnp.where(abx <= xlim4, k4a, k4b)

    return jnp.where(
        abx >= xlim0, k0,
        jnp.where(abx >= xlim1, k1,
                  jnp.where(abx >= xlim2, k2,
                            jnp.where(abx < xlim3, k3, k4))))


def voigt_far_wing(dv, lorentz_hwhm, doppler_hwhm):
    """Far-wing Voigt: Humlicek regions 0/1 only (plus the pure-Lorentz
    limit), exact wherever |x| >= sqrt(164) ~ 12.81 — beyond the largest
    possible region-1 lower bound (RFM_voigt.c:112-116: XLIM1 peaks at
    y=0), where the full region select can only ever pick region 0 or 1.

    The dense-window accumulators use this for grid points more than a
    few Doppler widths from every line center (~30 flops/point instead of
    the ~400 of the all-region evaluation), with the near-core points
    handled by :func:`voigt_line_shape`.
    """
    repwid = constants.SQRT_LN2 / doppler_hwhm
    y_true = repwid * lorentz_hwhm
    # Same region/limit structure as voigt_line_shape (Humlicek regions
    # see y clamped to 70; y >= 70.55 short-circuits to pure Lorentz), but
    # all three rationals share ONE division: select numerator and
    # denominator first.  Per-line factors are hoisted off the point axis.
    y = jnp.minimum(y_true, 70.0)
    yq = y * y
    a0 = yq + 0.5
    d0 = a0 * a0
    d2 = yq + yq - 1.0
    xlim0sq = 15100.0 + y * (40.0 - y * 3.6)
    c_scale = constants.RSQRPI * constants.RSQRPI * repwid  # (RSQRPI^2 = 1/pi)
    num0 = c_scale * y                         # region 0: y / (pi (xq+yq))
    lor_num = repwid * y_true / _PI            # Lorentz limit numerator
    ytq = y_true * y_true

    xi = dv * repwid
    xq = xi * xi
    num1 = num0 * (a0 + xq)                    # region 1 numerator
    den1 = d0 + xq * (d2 + xq)
    reg0 = xq >= xlim0sq
    lor = y_true >= 70.55
    num = jnp.where(lor, lor_num, jnp.where(reg0, num0, num1))
    den = jnp.where(lor, xq + ytq, jnp.where(reg0, xq + yq, den1))
    return num / den


def voigt_line_shape(dv, lorentz_hwhm, doppler_hwhm):
    """Voigt profile K(v - v0) [cm] matching rfm_voigt_line_shape.

    Args:
      dv: wavenumber offsets from the (pressure-shifted) line center [cm-1];
        any broadcastable shape.
      lorentz_hwhm: Lorentz half width at half maximum [cm-1].
      doppler_hwhm: Doppler HWHM (already including sqrt(ln2), i.e. the
        reference's ``alpha``) [cm-1].

    Returns elementwise profile values; multiply by line strength and column
    density for optical depth.
    """
    repwid = constants.SQRT_LN2 / doppler_hwhm
    y = repwid * lorentz_hwhm
    xi = dv * repwid
    # Pure-Lorentz limit for y >= 70.55 (RFM_voigt.c:97-106).
    lorentz = repwid * y / (_PI * (xi * xi + y * y))
    # Clamp y in the Humlicek path to avoid spurious NaNs in unused lanes.
    y_safe = jnp.minimum(y, 70.0)
    k = constants.RSQRPI * repwid * humlicek_k(xi, y_safe)
    return jnp.where(y >= 70.55, lorentz, k)
