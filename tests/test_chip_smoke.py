"""chip_smoke.py off a GPU, and the compiled kernel on one.

The CPU cases check the script's contract: no result line and a non-zero
exit without a GPU, or without the rest of the repository.  The ``gpu``
cases run with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _run(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _no_result(out):
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_without_gpu():
    out = _run(ROOT, {**os.environ, "JAX_PLATFORMS": "cpu"})
    _no_result(out)
    assert "no GPU" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(SCRIPT, tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    _no_result(_run(tmp_path, {**env, "JAX_PLATFORMS": "cpu"}))


def _gas_pair(pallas_modes):
    from grtcode_jax.gas_optics.gas_optics import GasOptics
    from grtcode_jax.gas_optics.hitran import synthetic_catalog
    from grtcode_jax.spectral import SpectralGrid

    grid = SpectralGrid(1000.0, 1400.0, 0.1)
    rng = np.random.default_rng(1)
    L = 3000
    cat = synthetic_catalog(
        1, np.sort(rng.uniform(990.0, 1410.0, L)),
        10.0 ** rng.uniform(-23.0, -19.5, L),
        yair=rng.uniform(0.02, 0.1, L), yself=rng.uniform(0.05, 0.4, L),
        en=rng.uniform(0.0, 2000.0, L), n=rng.uniform(0.4, 0.8, L),
        d=rng.uniform(-0.01, 0.01, L))
    nlev = 20
    p = jnp.asarray(np.linspace(0.01, 1013.0, nlev)[None] * np.ones((8, 1)),
                    jnp.float32)
    t = jnp.asarray(np.linspace(210.0, 290.0, nlev)[None]
                    + rng.uniform(-5, 5, (8, nlev)), jnp.float32)
    vmr = {1: jnp.full((8, nlev), 3e-3, jnp.float32)}
    taus = []
    for mode in pallas_modes:
        gas = GasOptics(grid, line_chunk=256, pallas=mode)
        gas.add_catalog(cat)
        taus.append(np.asarray(gas.optical_depth(p, t, vmr)))
    return taus


@pytest.mark.gpu
def test_compiled_kernel_matches_jnp(gpu):
    """pallas='on' compiles the kernel for the card and agrees with the
    jnp path within chip_smoke's parity bound."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    on, off = _gas_pair(("on", "off"))
    assert np.isfinite(on).all()
    rel = np.abs(on - off) / np.maximum(np.abs(off), chip_smoke.PARITY_FLOOR)
    assert rel.max() <= chip_smoke.PARITY_RTOL


@pytest.mark.gpu
def test_auto_takes_the_kernel_on_gpu(gpu):
    from grtcode_jax.gas_optics.gas_optics import GasOptics
    from grtcode_jax.spectral import SpectralGrid

    assert GasOptics(SpectralGrid(1.0, 10.0, 0.1))._use_kernel()


def test_float64_tau_matches_jnp_path():
    """chip_smoke's float64 reference sum equals the float32 jnp path at
    sampled points of a small catalog (near core and far wings)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from grtcode_jax.gas_optics.gas_optics import GasOptics
    from grtcode_jax.gas_optics.hitran import synthetic_catalog
    from grtcode_jax.gas_optics.lines import prepare
    from grtcode_jax.spectral import SpectralGrid

    grid = SpectralGrid(1000.0, 1100.0, 0.1)
    rng = np.random.default_rng(4)
    L = 400
    gas = GasOptics(grid, line_chunk=256, pallas="off")
    gas.add_catalog(synthetic_catalog(
        1, np.sort(rng.uniform(995.0, 1105.0, L)),
        10.0 ** rng.uniform(-23.0, -19.5, L),
        yair=rng.uniform(0.02, 0.1, L), yself=rng.uniform(0.05, 0.4, L),
        en=rng.uniform(0.0, 2000.0, L), n=rng.uniform(0.4, 0.8, L),
        d=rng.uniform(-0.01, 0.01, L)))
    rows = 6
    prep = prepare(gas.molecules[1], grid,
                   jnp.geomspace(1e-3, 1.0, rows, dtype=jnp.float32),
                   jnp.linspace(210.0, 290.0, rows, dtype=jnp.float32),
                   jnp.full((rows,), 1e-3, jnp.float32), tips=gas.tips)
    arrays = (prep.center_idx, prep.center_frac, prep.strength,
              prep.lorentz, prep.doppler)
    ns = jnp.full((rows,), 1e21, jnp.float32)
    tau = np.asarray(chip_smoke.accumulators(gas, 1)["jnp"](
        arrays, ns, 0, grid.n))
    points = [(r, int(g)) for r in range(rows)
              for g in rng.integers(0, grid.n, 20)]
    points.append(np.unravel_index(tau.argmax(), tau.shape))
    exact = chip_smoke.float64_tau(gas, 1, arrays, ns, points)
    got = np.array([tau[p] for p in points])
    assert exact.max() > 1.0
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-12)
