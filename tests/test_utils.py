"""Interpolation / integration / Curtis-Godson semantics
(utilities/src/utilities.c:35-381, curtis_godson.c:25-125)."""
import numpy as np
import jax.numpy as jnp

from grtcode_jax import constants
from grtcode_jax.utils.curtis_godson import (
    layer_pressures_temperatures,
    number_densities,
    partial_pressures_and_densities,
)
from grtcode_jax.utils.interp import (
    angstrom_exponent_sample,
    interpolate_piecewise,
    trapezoid_integral,
    trapezoid_uniform,
)


def test_interpolate_interior():
    x = np.array([0.0, 1.0, 2.0, 4.0])
    y = np.array([0.0, 10.0, 20.0, 40.0])
    newx = np.array([0.5, 1.5, 3.0])
    out = interpolate_piecewise(x, y, newx)
    np.testing.assert_allclose(out, [5.0, 15.0, 30.0])


def test_interpolate_outside_fill():
    x = np.array([1.0, 2.0, 3.0])
    y = np.array([10.0, 20.0, 30.0])
    newx = np.array([0.0, 5.0])
    out = interpolate_piecewise(x, y, newx, extrapolate="none", fill=0.0)
    np.testing.assert_allclose(out, [0.0, 0.0])


def test_interpolate_constant_extrapolation():
    # Reference quirk: right side extrapolates from x[n-2] with constant rule,
    # yielding y[n-2] (utilities.c:216-219).
    x = np.array([1.0, 2.0, 3.0])
    y = np.array([10.0, 20.0, 30.0])
    newx = np.array([0.5, 4.0])
    out = interpolate_piecewise(x, y, newx, extrapolate="constant")
    np.testing.assert_allclose(out, [10.0, 20.0])


def test_interpolate_left_edge_inclusive():
    # newx == x[0] is handled by the extrapolation rule (utilities.c:173-177).
    x = np.array([1.0, 2.0, 3.0])
    y = np.array([10.0, 20.0, 30.0])
    out = interpolate_piecewise(x, y, np.array([1.0]), extrapolate="none",
                                fill=-1.0)
    np.testing.assert_allclose(out, [-1.0])


def test_trapezoid():
    x = np.array([0.0, 1.0, 3.0])
    y = np.array([0.0, 2.0, 4.0])
    assert trapezoid_integral(x, y) == 1.0 + 6.0
    yu = np.array([[1.0, 2.0, 3.0], [2.0, 2.0, 2.0]])
    np.testing.assert_allclose(trapezoid_uniform(yu, 0.5), [2.0, 2.0])


def test_angstrom_exponent():
    x = np.array([1000.0, 2000.0])
    y = np.array([0.5, 0.25])
    # alpha = log(0.25/0.5)/log(1000/2000) = 1
    out = angstrom_exponent_sample(x, y, np.array([4000.0]))
    np.testing.assert_allclose(out, [0.125])


def test_number_densities():
    p = jnp.asarray([1.0, 0.5, 0.25])
    n = np.asarray(number_densities(p))
    np.testing.assert_allclose(
        n, [constants.COLUMN_DENSITY_C * 0.5, constants.COLUMN_DENSITY_C * 0.25],
        rtol=1e-6)


def test_layer_midpoints():
    p = jnp.asarray([1000.0, 800.0, 500.0])
    t = jnp.asarray([300.0, 280.0, 250.0])
    pavg, tavg = layer_pressures_temperatures(p, t)
    np.testing.assert_allclose(np.asarray(pavg), [900.0, 650.0])
    np.testing.assert_allclose(np.asarray(tavg), [290.0, 265.0])


def test_partial_pressures():
    # ps = 1/3(x0 p0 + x1 p1) + 1/6(x0 p1 + x1 p0) (curtis_godson.c:92-106).
    p = jnp.asarray([1.0, 0.5])
    x = jnp.asarray([0.01, 0.02])
    n = jnp.asarray([7.0])
    ps, ns = partial_pressures_and_densities(p, x, n)
    expect_ps = (0.01 * 1.0 + 0.02 * 0.5) / 3.0 + (0.01 * 0.5 + 0.02 * 1.0) / 6.0
    np.testing.assert_allclose(np.asarray(ps), [expect_ps], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ns), [7.0 * 0.015], rtol=1e-6)


def test_batched_curtis_godson():
    p = jnp.ones((5, 3)) * jnp.asarray([1.0, 0.6, 0.2])
    n = number_densities(p)
    assert n.shape == (5, 2)
