"""The port's step past the resident cap, as the JAX package's is: the
longest test of the soft slice, in a file of its own so that a worker of the
suite's `--dist loadfile` runs it beside the others (the set-up and `_both_steps`
are `tests/test_torch_step_soft.py`'s)."""

import numpy as np

from gpmpc_tpu_torch.ops import sqp_lanes as t_sqp_lanes
from tests._torch_threads import _one_thread  # noqa: F401
from tests.test_torch_step_soft import _both_steps, _count_calls


def test_hard_step_T52_tier1_matches_jax_lanes_step(monkeypatch):
    """T=52, B=3, hard bounds: past the resident cap of both packages as they
    are (about half a minute: the Pallas kernels run in interpret mode)."""
    calls_t = _count_calls(monkeypatch, t_sqp_lanes, "solve_ocp_qp_lanes_streamed")
    u_j, u_t, _, _ = _both_steps(52, 3, None, sqp_iters=2, qp_iters=6)
    assert len(calls_t) > 0
    np.testing.assert_allclose(u_t, u_j, atol=1e-3)
