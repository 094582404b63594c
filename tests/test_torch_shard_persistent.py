"""The persistent half of `test_torch_shard.py`'s parity matrix: the port's
sharded search on the "persistent" backend (kernel K5's plain version
here) against the reference's loop path on "pallas_persistent" (its
kernel in interpret mode), at S ∈ {1, 2, 4} × float32 / int8 / PQ, every
merged and stacked field, post and widen, probe then resume; and against
independent per-shard searches merged by a host lexsort.

Tolerance: none — the grid data (`tests/_shard_world.py`) make every
distance exact in both packages.
"""
import jax
import pytest

import _shard_world as W


@pytest.fixture(autouse=True)
def _drop_jax_executables():
    """Free the reference's compiled programs after each test: a process
    that keeps every one of this file's many shapes has crashed inside
    XLA's compiler."""
    yield
    jax.clear_caches()


@pytest.mark.parametrize("backend", ["persistent"])
@pytest.mark.parametrize("precision", ["float32", "int8", "pq"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_matches_reference(n_shards, precision, backend):
    """The port's sharded search (probe, then resume; post and widen) ==
    the reference's loop path in every merged and stacked field, and ==
    independent per-shard searches + a host lexsort merge, with merged
    counters the exact sums."""
    W.check_sharded_matches_reference(n_shards, precision, backend)
