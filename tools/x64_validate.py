"""Float64 validation mode: solvers vs the f64 reference C goldens.

The production pipeline is float32 by design (the reference itself
evaluates the Voigt in float locals even in its double build,
RFM_voigt.c:100-281), and PARITY.md documents the f32-parity argument.
This tool backs the remaining precision claim with an actual
``jax_enable_x64`` run: the LW and SW solvers execute in float64 on the
same cases the compiled f64 reference harnesses dumped
(tools/goldens/lw_harness.c / sw_harness.c) and must agree to ~1e-9 —
the goldens' own print precision (%.9e) — i.e. the reformulated
solvers (scan/einsum LW, overflow-free Meador-Weaver SW) are
algebraically exact against the reference, not merely f32-close.

Run:  JAX_ENABLE_X64=1 python tools/x64_validate.py   (CPU)
Exits 0 and prints X64 OK on success.
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=1")
os.environ["JAX_ENABLE_X64"] = "1"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

RTOL = 3e-9   # goldens are printed at %.9e (10 significant digits)


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from grtcode_jax.solvers.longwave import longwave_fluxes
    from grtcode_jax.solvers.shortwave import shortwave_fluxes
    import test_longwave as tlw
    import test_shortwave as tsw

    failures = 0
    golden = np.loadtxt(os.path.join(REPO, "tests", "data",
                                     "lw_golden.txt"))
    for ci, case in enumerate(tlw.CASES):
        offset = sum(c[0] * c[8] * 2 for c in tlw.CASES[:ci])
        nlevels, t_surf, emis, t_top, t_bot, tau_scale, w0, dw, nw = case
        t_layers, t_levels, tau, w = tlw._case_inputs(
            nlevels, t_top, t_bot, tau_scale, w0, dw, nw)
        fu, fd = longwave_fluxes(
            jnp.asarray(tau, jnp.float64),
            jnp.zeros((nlevels - 1, nw), jnp.float64),
            jnp.float64(t_surf), jnp.asarray(t_layers, jnp.float64),
            jnp.asarray(t_levels, jnp.float64),
            jnp.full((nw,), emis, jnp.float64), jnp.asarray(w))
        assert np.asarray(fu).dtype == np.float64
        block = golden[offset:offset + nlevels * nw * 2].reshape(
            nw, nlevels, 2)
        scale = block.max()
        for got, ref, nm in ((fu, block[:, :, 0].T, "up"),
                             (fd, block[:, :, 1].T, "down")):
            rel = np.abs(np.asarray(got) - ref) / \
                np.maximum(np.abs(ref), RTOL * scale)
            worst = rel.max()
            ok = worst <= RTOL * 10
            print(f"lw case {ci} {nm}: max rel {worst:.2e} "
                  f"{'ok' if ok else 'FAIL'}")
            failures += 0 if ok else 1

    golden = np.loadtxt(os.path.join(REPO, "tests", "data",
                                     "sw_golden.txt"))
    for ci, case in enumerate(tsw.CASES):
        offset = sum(c[0] * c[8] * 2 for c in tsw.CASES[:ci])
        (nlevels, mu_dir, mu_dif, a_dir, a_dif, tau_s, om_b, g_b,
         nw) = case
        tau, omega, g = tsw._case_inputs(nlevels, tau_s, om_b, g_b, nw)
        f64 = jnp.float64
        fu, fd = shortwave_fluxes(
            jnp.asarray(tau, f64), jnp.asarray(omega, f64),
            jnp.asarray(g, f64), jnp.float64(mu_dir),
            jnp.float64(mu_dif), jnp.full((nw,), a_dir, f64),
            jnp.full((nw,), a_dif, f64), jnp.float64(1.0),
            jnp.ones((nw,), f64))
        assert np.asarray(fu).dtype == np.float64
        block = golden[offset:offset + nlevels * nw * 2].reshape(
            nw, nlevels, 2)
        scale = block.max()
        for got, ref, nm in ((fu, block[:, :, 0].T, "up"),
                             (fd, block[:, :, 1].T, "down")):
            rel = np.abs(np.asarray(got) - ref) / \
                np.maximum(np.abs(ref), RTOL * scale)
            worst = rel.max()
            ok = worst <= RTOL * 10
            print(f"sw case {ci} {nm}: max rel {worst:.2e} "
                  f"{'ok' if ok else 'FAIL'}")
            failures += 0 if ok else 1

    if failures:
        print(f"X64 FAILED ({failures} cases)")
        return 1
    print("X64 OK: float64 solvers match the f64 reference goldens to "
          "print precision")
    return 0


if __name__ == "__main__":
    sys.exit(main())
