"""The port's observation adapters (`gpmpc_tpu_torch/utils/observations.py`)
against the reference's (`gpmpc_tpu/utils/observations.py`) on seeded
float32 inputs on both sides: general attitudes, and pitches within 1e-3 of
+/- pi/2, where tan and sec of the pitch reach ~1e3 and the rates ~1e4.

Tolerances: the angles and quaternion components (|.| <= pi) within 1e-6,
about 8 float32 ulps at pi (measured: 2.4e-7); the rates relative to
max(1, |rate|) within 4e-6, ~32 ulps (measured: 7.1e-7 at the pole, where
both sides amplify the same rounding of tan(pitch)); in `flatten_obs`, whose
pitch comes from each side's own `quat_to_euler`, that bar grows by twice
the pitches' difference over |cos(pitch)|, the rates' condition. The round trip
euler -> quat -> euler is held at general pitches (|pitch| <= 1.4) within
4e-6: at the pole the quaternion fixes only roll + yaw or roll - yaw, and
asin near 1 turns one ulp of its argument into ~5e-4 of pitch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.utils import observations as jo
from gpmpc_tpu_torch.utils import observations as to
from tests._torch_threads import _one_thread  # noqa: F401


ANGLE_TOL, RATE_TOL, ROUND_TRIP_TOL = 1e-6, 4e-6, 4e-6


def _attitudes(which: str, n: int = 256, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    roll, yaw = rng.uniform(-np.pi, np.pi, n), rng.uniform(-np.pi, np.pi, n)
    if which == "general":
        pitch = rng.uniform(-1.4, 1.4, n)
    else:  # within 1e-3 of +/- pi/2
        sign = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
        pitch = sign * (np.pi / 2 - rng.uniform(1e-5, 1e-3, n))
    return np.stack([roll, pitch, yaw], -1).astype(np.float32)


def _angle_diff(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 2 * np.pi - d)


@pytest.mark.parametrize("which", ["general", "near the pole"])
def test_quaternion_conversions_match_jax(which):
    rpy = _attitudes(which)
    q_j = np.asarray(jo.euler_to_quat(jnp.asarray(rpy)))
    q_t = to.euler_to_quat(torch.as_tensor(rpy)).numpy()
    assert q_t.dtype == np.float32 and q_t.shape == (256, 4)
    np.testing.assert_allclose(q_t, q_j, rtol=0, atol=ANGLE_TOL)
    e_j = np.asarray(jo.quat_to_euler(jnp.asarray(q_j)))
    e_t = to.quat_to_euler(torch.as_tensor(q_j.copy())).numpy()
    assert _angle_diff(e_t, e_j).max() <= ANGLE_TOL


@pytest.mark.parametrize("which", ["general", "near the pole"])
def test_rates_match_jax(which):
    rpy = _attitudes(which, seed=1)
    w = np.random.default_rng(2).normal(size=(256, 3)).astype(np.float32)
    r_j = np.asarray(jo.ang_vel_to_rpy_rates(jnp.asarray(w), jnp.asarray(rpy)))
    r_t = to.ang_vel_to_rpy_rates(torch.as_tensor(w), torch.as_tensor(rpy)).numpy()
    rel = np.abs(r_t - r_j) / np.maximum(1.0, np.abs(r_j))
    assert rel.max() <= RATE_TOL
    if which != "general":
        assert np.abs(r_j).max() > 1e3  # the pole's amplification is exercised


@pytest.mark.parametrize("which", ["general", "near the pole"])
def test_flatten_obs_matches_jax(which):
    rpy = _attitudes(which, n=16, seed=3)
    rng = np.random.default_rng(4)
    quats = np.asarray(jo.euler_to_quat(jnp.asarray(rpy)))
    for k in range(16):
        obs = {"pos": rng.normal(size=3).astype(np.float32), "quat": quats[k].copy(),
               "vel": rng.normal(size=3).astype(np.float32),
               "ang_vel": rng.normal(size=3).astype(np.float32)}
        s_j = np.asarray(jo.flatten_obs({k_: jnp.asarray(v) for k_, v in obs.items()}))
        s_t = to.flatten_obs({k_: torch.as_tensor(v) for k_, v in obs.items()}).numpy()
        assert s_t.shape == (12,) and s_t.dtype == np.float32
        np.testing.assert_array_equal(s_t[:6], s_j[:6])  # positions and velocities, copied
        assert _angle_diff(s_t[6:9], s_j[6:9]).max() <= ANGLE_TOL
        # the rates at each side's own pitch: one ulp of pitch apart moves tan and sec by
        # |d pitch| / |cos pitch| relative (x2 for margin) on top of their own rounding
        d_pitch = abs(float(s_t[7]) - float(s_j[7]))
        bar = RATE_TOL + 2 * d_pitch / abs(np.cos(float(s_j[7])))
        assert (np.abs(s_t[9:] - s_j[9:]) / np.maximum(1.0, np.abs(s_j[9:]))).max() <= bar


def test_round_trip_and_device():
    rpy = _attitudes("general", seed=5)
    back = to.quat_to_euler(to.euler_to_quat(torch.as_tensor(rpy))).numpy()
    assert _angle_diff(back, rpy).max() <= ROUND_TRIP_TOL
    q = to.euler_to_quat(torch.as_tensor(rpy, dtype=torch.float64))
    assert q.dtype == torch.float64 and q.device.type == "cpu"  # follows its input
    np.testing.assert_allclose(torch.linalg.norm(q, dim=-1).numpy(), 1.0, atol=1e-12)
