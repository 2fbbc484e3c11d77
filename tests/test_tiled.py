"""Tile-gather accumulation == scatter-add accumulation.

The tiled method (lines.build_tiles + optical_depth.accumulate_tiled) is
the jnp production path; the scatter path (accumulate_line_sample) is the
portable ground truth.  Both must produce identical tau, including with
spectral-block offsets (sharding) and pressure-shifted centers.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from grtcode_jax.spectral import SpectralGrid
from grtcode_jax.gas_optics.gas_optics import GasOptics
from grtcode_jax.gas_optics.hitran import synthetic_catalog


def _gas(method, n_lines=300, seed=3):
    grid = SpectralGrid(100.0, 400.0, 0.1)
    rng = np.random.default_rng(seed)
    vnn = np.sort(rng.uniform(80.0, 420.0, n_lines))
    cat = synthetic_catalog(
        1, vnn, rng.uniform(1e-22, 1e-19, n_lines),
        yair=rng.uniform(0.02, 0.1, n_lines),
        yself=rng.uniform(0.05, 0.4, n_lines),
        en=rng.uniform(0.0, 2000.0, n_lines),
        n=rng.uniform(0.4, 0.8, n_lines),
        d=rng.uniform(-0.02, 0.02, n_lines))
    gas = GasOptics(grid, line_chunk=64, method=method, tile_lchunk=32)
    gas.add_catalog(cat)
    return gas


@pytest.fixture(scope="module")
def atmos():
    rng = np.random.default_rng(11)
    nlev = 9
    p = jnp.asarray(np.linspace(0.01, 1013.0, nlev), jnp.float32)
    t = jnp.asarray(np.linspace(215.0, 288.0, nlev)
                    + rng.uniform(-3, 3, nlev), jnp.float32)
    x = jnp.asarray(rng.uniform(1e-5, 1e-2, nlev), jnp.float32)
    return p, t, x


def test_tiled_matches_scatter_full_grid(atmos):
    p, t, x = atmos
    tau_sc = _gas("scatter").optical_depth(p, t, {1: x})
    tau_ti = _gas("tiled").optical_depth(p, t, {1: x})
    np.testing.assert_allclose(np.asarray(tau_ti), np.asarray(tau_sc),
                               rtol=1e-6, atol=1e-12)


def test_tiled_matches_scatter_blocks(atmos):
    p, t, x = atmos
    gas_ti = _gas("tiled")
    gas_sc = _gas("scatter")
    full = np.asarray(gas_sc.optical_depth(p, t, {1: x}))
    tile = gas_ti.tile
    n = gas_ti.grid.n
    nblocks = 3
    block = -(-(-(-n // nblocks)) // tile) * tile
    got = np.zeros_like(full[:, :nblocks * block], shape=(full.shape[0],
                                                          nblocks * block))
    for b in range(nblocks):
        got[:, b * block:(b + 1) * block] = np.asarray(
            gas_ti.optical_depth(p, t, {1: x}, block_start=b * block,
                                 block_size=block))
    np.testing.assert_allclose(got[:, :n], full, rtol=1e-6, atol=1e-12)


def test_block_scatter_matches_full(atmos):
    """The scatter path also supports block offsets."""
    p, t, x = atmos
    gas = _gas("scatter")
    full = np.asarray(gas.optical_depth(p, t, {1: x}))
    block = 512
    got = np.asarray(gas.optical_depth(p, t, {1: x}, block_start=512,
                                       block_size=block))
    np.testing.assert_allclose(got, full[:, 512:1024], rtol=1e-6, atol=1e-12)
