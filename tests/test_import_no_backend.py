"""Importing the package must NOT initialize any JAX backend.

The multi-device dry run does a bare ``import __graft_entry__`` and only
then calls ``dryrun_multichip``, which provisions a virtual CPU mesh — a
configuration that can no longer change once a backend is live. Any
module-scope eager jnp op anywhere in the import graph initializes the
*default* backend (``ops/bvh.py`` once had a module-scope ``jnp.int32``),
and on a machine with a GPU it would also claim most of the card's memory
for a process that only meant to import. Reference parity: the C++
reference has no import-time device side effects at all (main.cpp:18-60
constructs state lazily).

Runs in a subprocess so this test is immune to conftest's own backend
setup, and imports EVERY nbody_jax submodule plus ``__graft_entry__`` so a
regression anywhere in the package trips it.
"""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import pkgutil
import sys

import nbody_jax

mods = ["__graft_entry__", "nbody_jax"]
for info in pkgutil.walk_packages(nbody_jax.__path__, prefix="nbody_jax."):
    mods.append(info.name)
for name in mods:
    __import__(name)

import jax._src.xla_bridge as xb
live = list(getattr(xb, "_backends", {}))
assert not live, f"importing {mods} initialized backends: {live}"
print("OK", len(mods))
"""


def test_import_whole_package_initializes_no_backend():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, (
        f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")
    assert proc.stdout.startswith("OK")
