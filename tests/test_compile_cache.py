"""Where ``import nbody_jax`` puts JAX's persistent compilation cache.

With ``JAX_COMPILATION_CACHE_DIR`` set, JAX uses that directory and the
package sets no other; without it, the package sets a fixed ``.jax_cache``
in the checkout, on every platform. Each case runs in a fresh interpreter,
since the setting is made at import time.
"""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = ("import jax, nbody_jax; "
          "print(jax.config.jax_compilation_cache_dir); "
          "print(nbody_jax.DEFAULT_CACHE_DIR)")


def _cache_dirs(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.split()


def test_default_cache_is_fixed_in_checkout():
    used, default = _cache_dirs(None)
    assert used == default == str(REPO / ".jax_cache")


def test_env_cache_dir_wins(tmp_path):
    want = str(tmp_path / "cache")
    used, default = _cache_dirs(want)
    assert used == want and default != want


def test_cache_dir_is_gitignored():
    lines = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines
