"""Regression tests for the entry shim (__graft_entry__.py).

These tests import the shim and run both hooks on the fake 8-device CPU
mesh, so an arity or sharding mistake in either hook fails here.
"""

import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import __graft_entry__ as graft  # noqa: E402


def test_entry_compiles_and_runs():
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    leaves = jax.tree.leaves(out)
    assert leaves, "entry() returned no outputs"
    for leaf in leaves:
        assert bool(jax.numpy.all(jax.numpy.isfinite(leaf)))


def test_dryrun_multichip_8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    graft.dryrun_multichip(8)  # asserts internally on finite deltas


@pytest.mark.slow
def test_dryrun_multichip_uneven_device_count():
    # driver may probe other counts; padding must handle non-divisors
    graft.dryrun_multichip(4)
