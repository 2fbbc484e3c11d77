"""Multi-stream discrete-ordinates shortwave solver (DISORT adapter parity).

Equivalent of the reference's optional cdisort adapter
(shortwave/src/disort_shortwave.c:18-86): azimuthally-averaged, flux-only,
16-stream plane-parallel solve with a Lambertian surface and a
Henyey-Greenstein phase function, driven per wavenumber.

Instead of cdisort's per-wavenumber eigen-decomposition C loop, each
homogeneous layer's diffuse reflection/transmission operators (h x h
matrices, h = nstr/2 Gauss streams per hemisphere) are built by MATRIX
DOUBLING from an infinitesimal single-scattering initializer, and layers
combine with the matrix ADDING method — the exact multi-stream
generalization of the reference's two-stream Briegleb adding
(shortwave.c:242-330).  Everything is batched (layer, wavenumber) matmuls
and solves; no data-dependent control flow, no eigendecompositions.  The
matmuls run at HIGHEST precision: a GPU's default float32 matmul may use
TF32 (about three decimal digits), far outside the solver's tolerance.

Delta-M scaling truncates the HG phase function at the stream count, as
cdisort does by default.

Conventions match the two-stream solver: level 0 = TOA; incident direct
flux at TOA on the horizontal = total_solar_irradiance * solar_flux(w)
* mu0; returned fluxes are per-wavenumber [W cm m-2].
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_DOUBLINGS = 37     # max doubling steps (covers tau up to _TAU_CLAMP)
_DTAU_TARGET = 1e-5  # initializer sub-layer thickness (single-scatter
                     # truncation error is ~linear in this after doubling)
_TAU_CLAMP = 1e6    # beyond this a layer is numerically opaque in f32


def gauss_streams(nstr: int):
    """Full-range Gauss-Legendre quadrature (positive hemisphere).

    The nstr-point rule on (-1, 1) integrates Legendre polynomials up to
    degree 2*nstr - 1 exactly, so the truncated phase function is
    normalized exactly by the quadrature — the discrete-ordinates energy
    conservation condition (a half-range rule would leak ~1%/unit-tau for
    conservative scattering).  This matches DISORT's stream placement.
    """
    if nstr < 4 or nstr % 2:
        raise ValueError("nstr must be an even integer >= 4")
    x, w = np.polynomial.legendre.leggauss(nstr)
    pos = x > 0
    order = np.argsort(x[pos])
    return x[pos][order].astype(np.float64), w[pos][order].astype(np.float64)


def _legendre_table(mu: np.ndarray, lmax: int) -> np.ndarray:
    """P_l(mu) for l = 0..lmax, shape (lmax+1, len(mu)); host-side."""
    out = np.empty((lmax + 1, mu.shape[0]))
    out[0] = 1.0
    if lmax >= 1:
        out[1] = mu
    for l in range(2, lmax + 1):
        out[l] = ((2 * l - 1) * mu * out[l - 1]
                  - (l - 1) * out[l - 2]) / l
    return out


def _legendre_mu0(mu0, lmax: int):
    """P_l(mu0) for traced mu0, stacked (lmax+1,)."""
    ps = [jnp.ones_like(mu0)]
    if lmax >= 1:
        ps.append(mu0)
    for l in range(2, lmax + 1):
        ps.append(((2 * l - 1) * mu0 * ps[-1] - (l - 1) * ps[-2]) / l)
    return jnp.stack(ps)


def _adding(Ra, Ta, sra, sta, da, Rb, Tb, srb, stb, db):
    """Combine layer a (top) over stack b (bottom).

    R/T: (.., h, h) diffuse reflection/transmission (symmetric layers);
    sr/st: (.., h) upward/downward diffuse responses at the object's
    top/bottom to a unit direct beam incident on its top; d: direct
    transmission.  Matrices act on intensity vectors from the right-ish:
    (R @ I) with I shaped (.., h).
    """
    eye = jnp.eye(Ra.shape[-1], dtype=Ra.dtype)
    # Interface multiple scattering: downward diffuse at the interface is
    # D = (I - Ra Rb)^-1 (Ta v + sources); note the operator ORDER — Ra
    # reflects upward-moving radiation back down, Rb reflects downward up.
    m = eye - Ra @ Rb
    rhs = sta + jnp.einsum("...ij,...j->...i", Ra, srb * da[..., None])
    D = jnp.linalg.solve(m, rhs[..., None])[..., 0]
    U = jnp.einsum("...ij,...j->...i", Rb, D) + srb * da[..., None]
    sr = sra + jnp.einsum("...ij,...j->...i", Ta, U)
    st = stb * da[..., None] + jnp.einsum("...ij,...j->...i", Tb, D)
    minvTa = jnp.linalg.solve(m, Ta)
    R = Ra + Ta @ (Rb @ minvTa)
    T = Tb @ minvTa
    return R, T, sr, st, da * db


@partial(jax.jit, static_argnames=("nstr", "deltam", "wchunk"))
@jax.default_matmul_precision("highest")
def disort_shortwave(tau, omega, g, mu_dir, albedo_dir,
                     total_solar_irradiance, solar_flux, *, nstr: int = 16,
                     deltam: bool = True, wchunk: int = 2048):
    """Discrete-ordinates SW fluxes (disort_shortwave.c:18-86 parity).

    Args:
      tau, omega, g: (nlayers, nw) layer optical depth / single-scatter
        albedo / asymmetry factor.
      mu_dir: () beam cosine (> 0).
      albedo_dir: (nw,) Lambertian surface albedo.
      total_solar_irradiance: () [W m-2].
      solar_flux: (nw,) normalized solar spectrum (integrates to 1).
      nstr: number of streams (16 matches the reference adapter).
      deltam: apply delta-M truncation scaling.
      wchunk: wavenumbers per processing block (bounds the
        (nlevels, wchunk, h, h) memory).

    Returns (flux_up, flux_down), each (nlevels, nw) [W cm m-2].
    """
    h = nstr // 2
    mu_np, w_np = gauss_streams(nstr)
    lmax = nstr
    pl = _legendre_table(mu_np, lmax)                  # (L+1, h)
    mu = jnp.asarray(mu_np, jnp.float32)
    wq = jnp.asarray(w_np, jnp.float32)
    # (L+1, h, h) same-/opposite-hemisphere Legendre products.
    sign = (-1.0) ** np.arange(lmax + 1)
    coef = (2 * np.arange(lmax + 1) + 1)
    ppp_l = jnp.asarray(coef[:, None, None] * pl[:, :, None] *
                        pl[:, None, :], jnp.float32)
    ppm_l = jnp.asarray((coef * sign)[:, None, None] * pl[:, :, None] *
                        pl[:, None, :], jnp.float32)
    pl_dev = jnp.asarray(pl, jnp.float32)              # (L+1, h)
    p0 = _legendre_mu0(jnp.asarray(mu_dir, jnp.float32), lmax)  # (L+1,)
    mu0 = jnp.asarray(mu_dir, jnp.float32)

    nlayers, nw = tau.shape
    nlev = nlayers + 1

    def solve_block(args):
        tau, omega, g, alb, fbeam = args               # (nlayers, W) ...
        tau = jnp.clip(jnp.asarray(tau, jnp.float32), 0.0, _TAU_CLAMP)
        omega = jnp.clip(jnp.asarray(omega, jnp.float32), 0.0, 1.0)
        gg = jnp.asarray(g, jnp.float32)

        # HG moments chi_l = g^l, optionally delta-M scaled
        # (f = g^nstr): chi' = (chi - f)/(1 - f), omega/tau rescaled.
        ls = jnp.arange(lmax + 1, dtype=jnp.float32)
        chi = gg[..., None] ** ls                      # (nlayers, W, L+1)
        if deltam:
            f = gg ** nstr
            chi = (chi - f[..., None]) / (1.0 - f[..., None])
            tau_s = (1.0 - omega * f) * tau
            omega = (1.0 - f) * omega / (1.0 - omega * f)
            tau = tau_s

        # Phase matrices and beam phase vectors.
        p_pp = jnp.einsum("lwk,lij->wkij", chi.transpose(2, 0, 1), ppp_l)
        p_pm = jnp.einsum("lwk,lij->wkij", chi.transpose(2, 0, 1), ppm_l)
        # p(+-mu_i, -mu0) = sum (2l+1) chi_l P_l(mu_i) P_l(mu0) (-+1)^l
        base = (2.0 * ls + 1.0) * p0                   # (L+1,)
        pb_p = jnp.einsum("lwk,l,li->wki", chi.transpose(2, 0, 1),
                          jnp.asarray((-1.0) ** np.arange(lmax + 1),
                                      jnp.float32), pl_dev * base[:, None])
        pb_m = jnp.einsum("lwk,li->wki", chi.transpose(2, 0, 1),
                          pl_dev * base[:, None])

        # Infinitesimal-layer initializer at dtau = tau / 2^k with a
        # PER-LAYER doubling count k: a fixed global 2^K split would make
        # exp(-dtau/mu) round to 1.0 in f32 for thin layers, silently
        # losing all attenuation.  k is chosen so dtau stays near
        # _DTAU_TARGET; thin layers (tau <= target) use k = 0 (their
        # single-scatter initializer is already O(tau^2)-exact).
        k_layer = jnp.clip(
            jnp.ceil(jnp.log2(jnp.maximum(tau, 1e-30)
                              / jnp.float32(_DTAU_TARGET))),
            0.0, float(_DOUBLINGS))                    # (nlayers, W)
        dtau = tau / jnp.exp2(k_layer)
        x = (dtau[..., None] * omega[..., None] * 0.5) / mu  # (.., W, h)
        # The diffuse transmission is tracked SPLIT as T = E + Tt, with
        # E = diag(exp(-tau_partial/mu)) recomputed analytically at every
        # doubling level: squaring E numerically would amplify its f32
        # representation error by 2^k and destroy absorption accuracy.
        Tt0 = x[..., None] * p_pp * wq                 # scattered part
        R0 = x[..., None] * p_pm * wq
        # Beam responses: scaled so direct horizontal flux = mu0 * d and
        # diffuse "intensities" are 2*pi*I (flux units).
        sr0 = x * pb_p
        st0 = x * pb_m

        def att(i):
            """Analytic E (diffuse diag) and d (direct) at doubling
            level i, i.e. sub-layer thickness dtau * 2^i."""
            t_i = dtau * jnp.exp2(jnp.minimum(jnp.float32(i), k_layer))
            E = jnp.exp(-t_i[..., None] / mu)          # (nlayers, W, h)
            return E, jnp.exp(-t_i / mu0)

        def double(i, state):
            R, Tt, sr, st = state
            E, d = att(i)
            eye = jnp.eye(h, dtype=jnp.float32)
            m = eye - R @ R
            # With T_full = diag(E) + Tt and M = m^-1, the doubled
            # operators are T' = T_full M T_full and
            # R' = R + T_full R M T_full.  All diag(E) products are kept
            # symbolic (row/column scalings) so the exact attenuation
            # never passes through a solve or a subtraction:
            #   Sd := M T_full - diag(E) = Tt + M R (R T_full).
            RT = R * E[..., None, :] + R @ Tt          # R @ T_full
            Sd = Tt + jnp.linalg.solve(m, R @ RT)
            RS = R * E[..., None, :] + R @ Sd          # R @ M @ T_full
            R_n = R + E[..., :, None] * RS + Tt @ RS
            Tt_n = E[..., :, None] * Sd + Tt * E[..., None, :] + Tt @ Sd
            rhs = st + jnp.einsum("...ij,...j->...i", R,
                                  sr * d[..., None])
            D = jnp.linalg.solve(m, rhs[..., None])[..., 0]
            U = jnp.einsum("...ij,...j->...i", R, D) + sr * d[..., None]
            sr_n = sr + E * U + jnp.einsum("...ij,...j->...i", Tt, U)
            st_n = st * d[..., None] + E * D + \
                jnp.einsum("...ij,...j->...i", Tt, D)
            do = jnp.float32(i) < k_layer
            return tuple(
                jnp.where(do[..., None, None] if n.ndim == 4 else
                          do[..., None], n, o)
                for n, o in zip((R_n, Tt_n, sr_n, st_n), state))

        R, Tt, sr, st = jax.lax.fori_loop(
            0, _DOUBLINGS, double, (R0, Tt0, sr0, st0))
        E_fin, d = att(_DOUBLINGS)
        T = E_fin[..., :, None] * jnp.eye(h, dtype=jnp.float32) + Tt
        # (nlayers, W, h, h) / (nlayers, W, h) / (nlayers, W)

        # Surface "layer": Lambertian (disort_shortwave.c lamber=TRUE).
        # Normalized by the quadrature's actual sum(w mu) so that
        # F_up(sfc) == albedo * F_down(sfc) exactly.
        inv_swmu = 1.0 / jnp.sum(wq * mu)
        R_sfc = jnp.broadcast_to((inv_swmu * alb[:, None, None]) *
                                 (mu * wq)[None, None, :],
                                 (alb.shape[0], h, h))
        sr_sfc = jnp.broadcast_to((inv_swmu * alb * mu0)[:, None],
                                  (alb.shape[0], h))

        # Reverse scan: response of everything below each level.
        def below_step(carry, layer):
            Rb, srb = carry
            Ra, Ta, sra, sta, da = layer
            eye = jnp.eye(h, dtype=jnp.float32)
            m = eye - Ra @ Rb
            rhs = sta + jnp.einsum("...ij,...j->...i", Ra,
                                   srb * da[..., None])
            D = jnp.linalg.solve(m, rhs[..., None])[..., 0]
            U = jnp.einsum("...ij,...j->...i", Rb, D) + \
                srb * da[..., None]
            sr_new = sra + jnp.einsum("...ij,...j->...i", Ta, U)
            R_new = Ra + Ta @ (Rb @ jnp.linalg.solve(m, Ta))
            return (R_new, sr_new), (Rb, srb)

        (R0b, sr0b), belows = jax.lax.scan(
            below_step, (R_sfc, sr_sfc), (R, T, sr, st, d), reverse=True)
        # belows[k] = response of the stack below level k+1; prepend the
        # level-0 response.
        R_below = jnp.concatenate([R0b[None], belows[0]], axis=0)
        sr_below = jnp.concatenate([sr0b[None], belows[1]], axis=0)
        # R_below[k], sr_below[k]: stack below level k (k = 0..nlayers;
        # index nlayers = surface).

        # Forward scan: downward diffuse D_k and direct dir_k per level.
        def down_step(carry, layer):
            Dk, dirk = carry
            Ra, Ta, sta, da, Rb_next, srb_next = layer
            eye = jnp.eye(h, dtype=jnp.float32)
            dir_next = dirk * da
            rhs = jnp.einsum("...ij,...j->...i", Ta, Dk) + \
                sta * dirk[..., None] + \
                jnp.einsum("...ij,...j->...i", Ra,
                           srb_next * dir_next[..., None])
            m = eye - Ra @ Rb_next
            D_next = jnp.linalg.solve(m, rhs[..., None])[..., 0]
            return (D_next, dir_next), (D_next, dir_next)

        W = tau.shape[1]
        D0 = jnp.zeros((W, h), jnp.float32)
        dir0 = jnp.ones((W,), jnp.float32)
        _, (D_levels, dir_levels) = jax.lax.scan(
            down_step, (D0, dir0),
            (R, T, st, d, R_below[1:], sr_below[1:]))
        D_all = jnp.concatenate([D0[None], D_levels], axis=0)
        dir_all = jnp.concatenate([dir0[None], dir_levels], axis=0)
        U_all = jnp.einsum("kwij,kwj->kwi", R_below, D_all) + \
            sr_below * dir_all[..., None]

        wu = (wq * mu)[None, None, :]
        fup = (U_all * wu).sum(-1)
        fdn = (D_all * wu).sum(-1) + mu0 * dir_all
        return fup * fbeam[None, :], fdn * fbeam[None, :]

    # Spectral chunking bounds the (nlev, W, h, h) temporaries.
    nblk = -(-nw // wchunk)
    pad = nblk * wchunk - nw

    def padw(a):
        return jnp.pad(a, ((0, 0), (0, pad))) if a.ndim == 2 else \
            jnp.pad(a, (0, pad))

    fbeam = jnp.asarray(total_solar_irradiance, jnp.float32) * \
        jnp.asarray(solar_flux, jnp.float32)
    blocks = (
        padw(tau).reshape(nlayers, nblk, wchunk).transpose(1, 0, 2),
        padw(omega).reshape(nlayers, nblk, wchunk).transpose(1, 0, 2),
        padw(g).reshape(nlayers, nblk, wchunk).transpose(1, 0, 2),
        padw(jnp.asarray(albedo_dir, jnp.float32)).reshape(nblk, wchunk),
        padw(fbeam).reshape(nblk, wchunk),
    )
    fup_b, fdn_b = jax.lax.map(solve_block, blocks)
    fup = fup_b.transpose(1, 0, 2).reshape(nlev, nblk * wchunk)[:, :nw]
    fdn = fdn_b.transpose(1, 0, 2).reshape(nlev, nblk * wchunk)[:, :nw]
    return fup, fdn
