"""Driver contract: dryrun_multichip must keep compiling+running on a
virtual mesh between rounds (entry() is full-res and driver-tested)."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_8():
    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    g.dryrun_multichip(8)  # asserts internally (shapes + finiteness)


def test_entry_returns_jittable():
    sys.path.insert(0, REPO)
    import jax
    import __graft_entry__ as g

    fn, args = g.entry()
    # trace only (no full-res CPU compile in the suite): abstract eval
    shapes = jax.eval_shape(fn, *args)
    state, result = shapes
    assert result.shape == (3, 720, 1280)
    assert state.noisy.shape == (3, 720, 1280)
