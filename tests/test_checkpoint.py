import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_jax import random_system
from nbody_jax import checkpoint as C


@pytest.mark.parametrize("use_orbax", [False] +
                         ([True] if C.have_orbax() else []))
def test_roundtrip(rng_key, tmp_path, use_orbax):
    sys = random_system(rng_key, 64, dim=3)
    key = jax.random.key(123)
    path = C.save_checkpoint(str(tmp_path), sys, step=7, key=key,
                             use_orbax=use_orbax)
    assert path
    restored, step, rkey = C.load_checkpoint(str(tmp_path))
    assert step == 7
    np.testing.assert_array_equal(np.asarray(restored.positions),
                                  np.asarray(sys.positions))
    np.testing.assert_array_equal(np.asarray(restored.masses),
                                  np.asarray(sys.masses))
    # Restored key generates the same stream.
    a = jax.random.uniform(key, (4,))
    b = jax.random.uniform(rkey, (4,))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_latest_step(tmp_path, rng_key):
    sys = random_system(rng_key, 8, dim=2)
    assert C.latest_step(str(tmp_path)) is None
    C.save_checkpoint(str(tmp_path), sys, step=1, use_orbax=False)
    C.save_checkpoint(str(tmp_path), sys, step=5, use_orbax=False)
    assert C.latest_step(str(tmp_path)) == 5
    restored, step, key = C.load_checkpoint(str(tmp_path))
    assert step == 5 and key is None


def test_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        C.load_checkpoint(str(tmp_path))
