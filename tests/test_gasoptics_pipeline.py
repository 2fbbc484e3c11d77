"""Full gas-optics line pipeline parity against the reference C build.

Golden fixture tests/data/gasoptics_golden.txt is produced by
tools/goldens/gasoptics_harness.c, which compiles the unmodified reference
kernels (curtis_godson.c, kernels.c, RFM_voigt.c, kernel_utils.c,
spectral_bin.c) and drives the production line_sample sequence
(launch.c:100-161) on a deterministic synthetic H2O-like line list, with
Q() stubbed to the same power-law model as PowerLawTips (tips2017.c is a
stripped blob in the reference checkout).
"""
import os

import numpy as np
import pytest

from grtcode_jax import constants
from grtcode_jax.gas_optics.gas_optics import GasOptics
from grtcode_jax.gas_optics.hitran import synthetic_catalog
from grtcode_jax.spectral import SpectralGrid

HERE = os.path.dirname(__file__)
NUM_LEVELS, NUM_LAYERS, NUM_LINES = 9, 8, 40


def _lcg_params():
    """Reproduce the harness's LCG-generated line list exactly (uint32
    wraparound is the LCG's modulus — overflow is intended)."""
    v0 = np.empty(NUM_LINES)
    s0 = np.empty(NUM_LINES)
    yair = np.empty(NUM_LINES)
    yself = np.empty(NUM_LINES)
    en = np.empty(NUM_LINES)
    nexp = np.empty(NUM_LINES)
    d = np.empty(NUM_LINES)
    iso = np.empty(NUM_LINES, np.int32)
    s = np.uint32(12345)
    np_err = np.errstate(over="ignore")
    np_err.__enter__()
    for i in range(NUM_LINES):
        s = np.uint32(s * np.uint32(1103515245) + np.uint32(12345))
        r1 = float(s >> np.uint32(8)) / 16777216.0
        s = np.uint32(s * np.uint32(1103515245) + np.uint32(12345))
        r2 = float(s >> np.uint32(8)) / 16777216.0
        s = np.uint32(s * np.uint32(1103515245) + np.uint32(12345))
        r3 = float(s >> np.uint32(8)) / 16777216.0
        v0[i] = 150.0 + 200.0 * i / (NUM_LINES - 1.0) + 2.0 * (r1 - 0.5)
        s0[i] = 1e-23 * 10.0 ** (3.0 * r2)
        yair[i] = 0.02 + 0.08 * r3
        yself[i] = 0.1 + 0.3 * r1
        en[i] = 2000.0 * r2
        nexp[i] = 0.4 + 0.4 * r3
        d[i] = 0.02 * (r1 - 0.5)
        iso[i] = 1 + (i % 3)
    np_err.__exit__(None, None, None)
    return v0, s0, yair, yself, en, nexp, d, iso


@pytest.fixture(scope="module", params=["tiled", "scatter"])
def tau(request):
    v0, s0, yair, yself, en, nexp, d, iso = _lcg_params()
    cat = synthetic_catalog(1, v0, s0, yair=yair, yself=yself, en=en,
                            n=nexp, d=d, iso=iso)
    grid = SpectralGrid(100.0, 400.0, 0.1)
    gas = GasOptics(grid, line_chunk=64, method=request.param,
                    tile_lchunk=32)
    gas.add_catalog(cat)

    i = np.arange(NUM_LEVELS)
    p_atm = 1e-5 + (1.0 - 1e-5) * i / (NUM_LEVELS - 1.0)
    t = 215.0 + (288.0 - 215.0) * i / (NUM_LEVELS - 1.0)
    x = 1e-5 + 3e-3 * i / (NUM_LEVELS - 1.0)
    p_mb = p_atm / constants.MB_TO_ATM
    return np.asarray(gas.optical_depth(
        np.asarray(p_mb, np.float32), np.asarray(t, np.float32),
        {1: np.asarray(x, np.float32)}))


@pytest.fixture(scope="module")
def golden():
    return np.loadtxt(os.path.join(HERE, "data", "gasoptics_golden.txt")) \
        .reshape(NUM_LAYERS, 3001)


def test_pipeline_matches_reference(tau, golden):
    # f32 pipeline vs f64 reference: relative tolerance dominated by the
    # f32 exp() in the strength correction.
    np.testing.assert_allclose(tau, golden, rtol=5e-4, atol=1e-12)
    # And the overall magnitude is meaningful, not vacuous.
    assert golden.max() > 100.0 and (golden > 0).sum() > 15000
