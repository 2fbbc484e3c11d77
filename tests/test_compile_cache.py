"""Persistent compile cache location (grtcode_jax.compile_cache).

Each case compiles in a fresh interpreter, so the cache configuration of
the test process is never touched."""
import os
import random
import subprocess
import sys

from grtcode_jax.compile_cache import DEFAULT_DIR, ENV_VAR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_COMPILE = (
    "import jax, jax.numpy as jnp\n"
    "from grtcode_jax.compile_cache import enable_compile_cache\n"
    "print(enable_compile_cache())\n"
    "f = jax.jit(lambda x: jnp.sin(x) * {k} + 1.0)\n"
    "f(jnp.ones(7)).block_until_ready()\n"
)


def _compile(env):
    """Compile a function no earlier run has cached; returns the cache
    directory the helper reported."""
    env = {**env, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT}
    k = repr(random.random())
    out = subprocess.run([sys.executable, "-c", _COMPILE.format(k=k)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def _entries(d):
    return set(os.listdir(d)) if os.path.isdir(d) else set()


def test_cache_goes_to_environment_directory_only(tmp_path):
    before = _entries(DEFAULT_DIR)
    used = _compile({**os.environ, ENV_VAR: str(tmp_path)})
    assert used == str(tmp_path)
    assert _entries(tmp_path), "no compiled entry in the environment's dir"
    assert _entries(DEFAULT_DIR) == before


def test_cache_defaults_to_repo_directory():
    env = {k: v for k, v in os.environ.items() if k != ENV_VAR}
    before = _entries(DEFAULT_DIR)
    used = _compile(env)
    assert used == DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")
    assert _entries(DEFAULT_DIR) - before, "no new entry in <repo>/.jax_cache"
