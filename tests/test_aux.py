"""Auxiliary subsystems (SURVEY.md §5): metrics/profiling, debug-mode
numerical guards, segment manifest resume, combiner rebinning."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from grtcode_jax.framework import Atmosphere
from grtcode_jax.utils.debug import debug_mode, validate_atmosphere, checked
from grtcode_jax.utils.metrics import Metrics, grid_points, profiler_trace
from grtcode_jax.utils.segments import SegmentManifest, run_segments
from tools.combine_segments import rebin_spectral


def test_metrics_phase_and_throughput():
    m = Metrics()
    with m.phase("gas_optics", points=grid_points(4, 10, 1000)) as box:
        box["result"] = jnp.ones((4, 10)) * 2.0
    with m.phase("gas_optics", points=grid_points(4, 10, 1000)):
        pass
    st = m.phases["gas_optics"]
    assert st.calls == 2
    assert st.points == 2 * 4 * 10 * 1000
    assert st.seconds > 0
    assert m.points_per_second("gas_optics") > 0
    assert "gas_optics" in m.report()


def test_profiler_trace_noop():
    with profiler_trace(None):
        pass  # None logdir must be a clean no-op


def _tiny_atm(**over):
    base = dict(
        level_pressure=np.linspace(1.0, 1000.0, 11)[None],
        level_temperature=np.linspace(210.0, 290.0, 11)[None],
        layer_temperature=np.linspace(212.0, 288.0, 10)[None],
        surface_temperature=[290.0],
        ppmv={1: np.full((1, 11), 5000.0)},
    )
    base.update(over)
    return Atmosphere(**base)


def test_validate_atmosphere_accepts_good():
    validate_atmosphere(_tiny_atm())


def test_validate_atmosphere_range_guards():
    """Mirrors grtcode_config.h:52-99: temperature 100-500 K, layer count
    <= 200, probability in [0, 1]."""
    with pytest.raises(ValueError, match="temperature"):
        validate_atmosphere(_tiny_atm(
            level_temperature=np.full((1, 11), 600.0)))
    with pytest.raises(ValueError, match="layers"):
        validate_atmosphere(_tiny_atm(
            level_pressure=np.linspace(1.0, 1000.0, 250)[None],
            level_temperature=np.full((1, 250), 250.0),
            layer_temperature=np.full((1, 249), 250.0),
            ppmv={1: np.full((1, 250), 5000.0)}))
    with pytest.raises(ValueError, match="cloud_fraction"):
        validate_atmosphere(_tiny_atm(
            cloud_fraction=np.full((1, 10), 1.5),
            liquid_water_content=np.zeros((1, 10)),
            ice_water_content=np.zeros((1, 10)),
            layer_thickness=np.full((1, 10), 100.0),
            clear=False))


def test_debug_mode_traps_nan():
    @jax.jit
    def bad(x):
        return jnp.log(x)  # log(-1) -> NaN

    with pytest.raises(FloatingPointError):
        with debug_mode():
            jax.block_until_ready(bad(jnp.asarray(-1.0)))
    # Config restored: NaNs flow silently again outside the context.
    assert np.isnan(np.asarray(bad(jnp.asarray(-1.0))))


def test_checked_guard():
    from jax.experimental import checkify

    def f(x):
        checkify.check(jnp.all(x > 0), "x must be positive")
        return jnp.sqrt(x)

    err, val = checked(f)(jnp.asarray(4.0))
    err.throw()
    assert float(val) == 2.0
    err, _ = checked(f)(jnp.asarray(-4.0))
    with pytest.raises(Exception, match="positive"):
        err.throw()


def test_segment_manifest_resume(tmp_path):
    man = SegmentManifest(str(tmp_path))
    segs = {f"lon{i}": {"x": i} for i in range(4)}
    ran = run_segments(man, segs, lambda sid, a: tmp_path / f"{sid}.nc")
    assert ran == list(segs)
    assert man.pending(list(segs)) == []
    # Invalidate one -> only that one reruns.
    man.clear("lon2")
    ran2 = run_segments(man, segs, lambda sid, a: tmp_path / f"{sid}.nc")
    assert ran2 == ["lon2"]
    rec = man.record("lon2")
    assert rec["segment"] == "lon2" and rec["finished_at"] > 0


def test_rebin_spectral_matches_reference_combiner():
    """coarsen(w=10).sum()/10 over the trailing spectral axis
    (GRTworkflow/combiner.py:40-60)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 4, 5, 23))
    out = rebin_spectral(x, 10)
    assert out.shape == (2, 3, 4, 5, 2)
    np.testing.assert_allclose(out[..., 0], x[..., :10].mean(-1))
    np.testing.assert_allclose(out[..., 1], x[..., 10:20].mean(-1))


def test_verbosity_levels_and_error_buffer(capsys):
    """utilities/src/verbosity.c:28-83 equivalents."""
    from grtcode_jax.utils import verbosity as vb

    vb.clear_error_buffer()
    vb.set_verbosity(vb.GRTCODE_NONE)
    vb.log_info("hidden %d", 1)
    vb.log_warn("hidden")
    assert capsys.readouterr().err == ""
    vb.set_verbosity(vb.GRTCODE_WARN)
    vb.log_warn("warned")
    vb.log_info("hidden")
    assert "warned" in capsys.readouterr().err
    vb.set_verbosity(vb.GRTCODE_INFO)
    vb.log_info("shown %s", "x")
    assert "shown x" in capsys.readouterr().err

    vb.append_to_error_buffer("first failure")
    vb.append_to_error_buffer("second failure")
    s = vb.errstr()
    assert "first failure" in s and "second failure" in s
    assert "test_aux.py" in s  # file:line backtrace context
    # Bounded like the reference's 4 KB buffer.
    for i in range(200):
        vb.append_to_error_buffer("x" * 100)
    assert len(vb.errstr()) <= 4096
    vb.clear_error_buffer()
    assert vb.errstr() == ""
    import pytest
    with pytest.raises(ValueError):
        vb.set_verbosity(7)
    vb.set_verbosity(vb.GRTCODE_NONE)


def test_optics_update():
    """update_optics (optics.c:345-357) functional equivalent."""
    import jax.numpy as jnp
    import numpy as np
    import pytest
    from grtcode_jax.optics import Optics
    from grtcode_jax.spectral import SpectralGrid

    grid = SpectralGrid(1.0, 2.0, 0.5)
    o = Optics.zeros(2, grid)
    tau2 = jnp.ones((2, grid.n))
    o2 = o.update(tau=tau2)
    np.testing.assert_array_equal(np.asarray(o2.tau), 1.0)
    np.testing.assert_array_equal(np.asarray(o2.omega), 0.0)
    assert o2.grid == grid
    with pytest.raises(ValueError):
        o.update(g=jnp.ones((3, grid.n)))


def test_x64_validation_mode():
    """The float64 validation mode (PARITY.md row 3): solvers under
    jax_enable_x64 match the f64 reference C goldens to their print
    precision (~1e-9) — run in a subprocess because x64 is a global jax
    config this process must not inherit."""
    import subprocess
    import sys

    tool = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                        "x64_validate.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, tool], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "X64 OK" in proc.stdout
