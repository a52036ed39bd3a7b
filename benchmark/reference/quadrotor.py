"""The quadrotor in plain PyTorch: its attitude-interface dynamics, the
figure-eight reference, its residual GPs' features and the synthetic
residuals they learn, and the plant with rotor and attitude lag,
aerodynamic drag and one step of actuation delay. The family's module of the
reference (`benchmark/reference/<family>.py`), found by the configuration's
`family`.

State [x, dx, y, dy, z, dz, phi, theta, psi, dphi, dtheta, dpsi], input
[thrust, phi_cmd, theta_cmd, psi_cmd]. Acceleration a * thrust + b along the
body axis; dd_phi = c phi + d dphi + e phi_cmd; dd_theta = f theta + h dtheta
+ l theta_cmd (amacati/gp-mpc's attitude model). Three GPs learn the residual:
GP 0 the thrust magnitude from the thrust command, GP 1 the roll acceleration
from (phi, dphi, phi_cmd), GP 2 the pitch acceleration from (theta, dtheta,
theta_cmd); the thrust residual enters the world axes as (cos phi sin theta,
-sin phi, cos phi cos theta). Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.common import rk4

GRAVITY = 9.81
PARAM_KEYS = ("a", "b", "c", "d", "e", "f", "h", "l")
VEL_ROWS = (1, 3, 5)
# each GP's columns of z = [T, phi, dphi, phi_cmd, theta, dtheta, theta_cmd]
GP_COLUMNS = ((0,), (1, 2, 3), (4, 5, 6))
GP_ROWS = (1, 3, 5, 9, 10)  # the state rows the GPs act on
# the plant's state entries the output check compares, each with the box whose width scales it
PLANT_COMPARED = (("x", "state"), ("u_act", "input"))


def params_tensor(params: dict, device, dtype=torch.float32) -> torch.Tensor:
    """(8,) [a, b, c, d, e, f, h, l]."""
    return torch.tensor([float(params[k]) for k in PARAM_KEYS], dtype=dtype, device=device)


def dynamics(x: torch.Tensor, u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """dx/dt for states (..., 12), inputs (..., 4) and coefficients p (..., 8)
    or (8,)."""
    a, b, c, d, e, f, h, l = p.unbind(-1)  # noqa: E741
    phi, theta, psi = x[..., 6], x[..., 7], x[..., 8]
    acc = a * u[..., 0] + b
    cphi, sphi, cth, sth = torch.cos(phi), torch.sin(phi), torch.cos(theta), torch.sin(theta)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)
    return torch.stack([
        x[..., 1], acc * (cphi * sth * cpsi + sphi * spsi),
        x[..., 3], acc * (cphi * sth * spsi - sphi * cpsi),
        x[..., 5], acc * cphi * cth - GRAVITY,
        x[..., 9], x[..., 10], x[..., 11],
        c * phi + d * x[..., 9] + e * u[..., 1],
        f * theta + h * x[..., 10] + l * u[..., 2],
        torch.zeros_like(psi),
    ], dim=-1)


def figure_eight(n_steps: int, dt: float, amplitude: float, height: float, device) -> torch.Tensor:
    """(n_steps, 12): one period of the figure eight in the x-y plane at a
    fixed height, with its velocities."""
    t = torch.arange(n_steps, dtype=torch.float32, device=device) * dt
    w = 2.0 * math.pi / (n_steps * dt)
    ref = torch.zeros(n_steps, 12, dtype=torch.float32, device=device)
    ref[:, 0] = amplitude * torch.sin(w * t)
    ref[:, 1] = amplitude * w * torch.cos(w * t)
    ref[:, 2] = 0.5 * amplitude * torch.sin(2.0 * w * t)
    ref[:, 3] = amplitude * w * torch.cos(2.0 * w * t)
    ref[:, 4] = height
    return ref


def reference_trajectory(config: dict, device) -> torch.Tensor:
    """(N, 12) the periodic reference the controller tracks."""
    plant = config["plant"]
    return figure_eight(plant["n_steps"], config["dt"], plant["traj_amplitude"],
                        plant["traj_height"], device)


def start_state(config: dict, device) -> torch.Tensor:
    """(12,) the reference's first point, around which episodes start."""
    return reference_trajectory(config, device)[0]


def residual_dataset(n: int, rng: np.random.Generator):
    """(z (n, 7), y (n, 3)) float32: the thrust command and attitude inputs,
    the thrust-magnitude residual 4 + 0.5 sin(5 T) and two attitude-rate
    residuals linear in phi and theta, each with noise 0.01."""
    z = np.zeros((n, 7), np.float32)
    z[:, 0] = rng.uniform(0.2, 0.5, n)
    z[:, 1:] = rng.normal(0, 0.2, (n, 6))
    y = np.stack([4.0 + 0.5 * np.sin(5 * z[:, 0]) + 0.01 * rng.normal(size=n),
                  0.1 * z[:, 1] + 0.01 * rng.normal(size=n),
                  0.1 * z[:, 4] + 0.01 * rng.normal(size=n)], axis=1).astype(np.float32)
    return z, y


def gp_features(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """z (..., 7) = [thrust, phi, dphi, phi_cmd, theta, dtheta, theta_cmd]."""
    return torch.stack([u[..., 0], x[..., 6], x[..., 9], u[..., 1], x[..., 7], x[..., 10],
                        u[..., 2]], dim=-1)


def augmented(p: torch.Tensor, gp):
    """The controller's model: the prior's dynamics plus the GP means."""
    def f(x, u):
        z = gp_features(x, u)
        m = gp.mean(z)
        phi, theta = x[..., 6], x[..., 7]
        res = torch.stack([m[..., 0] * torch.cos(phi) * torch.sin(theta),
                           -m[..., 0] * torch.sin(phi),
                           m[..., 0] * torch.cos(phi) * torch.cos(theta),
                           m[..., 1], m[..., 2]], dim=-1)
        fx = dynamics(x, u, p)
        zero = torch.zeros_like(phi)
        rows = {r: i for i, r in enumerate(GP_ROWS)}
        return fx + torch.stack([res[..., rows[r]] if r in rows else zero for r in range(12)], -1)

    return f


def variance_factors(z: torch.Tensor) -> torch.Tensor:
    """F (..., 5, 3): how each GP's variance lands on the five GP rows."""
    phi, theta = z[..., 1], z[..., 4]
    F = torch.zeros(z.shape[:-1] + (5, 3), dtype=z.dtype, device=z.device)
    F[..., 0, 0] = (torch.cos(phi) * torch.sin(theta)) ** 2
    F[..., 1, 0] = torch.sin(phi) ** 2
    F[..., 2, 0] = (torch.cos(phi) * torch.cos(theta)) ** 2
    F[..., 3, 1] = 1.0
    F[..., 4, 2] = 1.0
    return F


class Plant:
    """The plant of one configuration: per-scenario coefficients (B, 8),
    first-order lags on the commands (rotor for the thrust, attitude for the
    angles) over `sim_substeps` RK4 substeps a step, linear and quadratic
    drag on the velocities, and `delay_steps` of actuation delay."""

    def __init__(self, cfg: dict, device):
        self.dt, self.substeps = float(cfg["dt"]), int(cfg["sim_substeps"])
        self.delay = int(cfg["delay_steps"])
        self.drag_lin, self.drag_quad = float(cfg["drag_lin"]), float(cfg["drag_quad"])
        sub = self.dt / self.substeps
        taus = (cfg["rotor_tau"], cfg["att_tau"], cfg["att_tau"], cfg["att_tau"])
        self.alpha = torch.tensor([1.0 - math.exp(-sub / tau) if tau > 0 else 1.0 for tau in taus],
                                  dtype=torch.float32, device=device)
        p = cfg["params"]
        self.hover = torch.tensor([(GRAVITY - p["b"]) / p["a"], 0.0, 0.0, 0.0],
                                  dtype=torch.float32, device=device)

    def initial(self, x0: torch.Tensor) -> dict:
        """The plant's state at an episode's start from x0 (B, 12)."""
        B = x0.shape[0]
        return dict(x=x0.clone(), t=torch.zeros(B, dtype=torch.int32, device=x0.device),
                    u_act=self.hover.expand(B, 4).clone(),
                    u_queue=self.hover.expand(B, self.delay, 4).clone())

    def step(self, state: dict, params: torch.Tensor, u: torch.Tensor) -> dict:
        """One control step of every scenario on the commands u (B, 4)."""
        def fc(x, v):
            f = dynamics(x, v, params)
            vel = x[..., list(VEL_ROWS)]
            drag = -(self.drag_lin + self.drag_quad * torch.linalg.vector_norm(vel, dim=-1,
                                                                              keepdim=True)) * vel
            f = f.clone()
            f[..., list(VEL_ROWS)] += drag
            return f

        if self.delay > 0:
            u_cmd = state["u_queue"][:, 0]
            queue = torch.cat([state["u_queue"][:, 1:], u[:, None]], dim=1)
        else:
            u_cmd, queue = u, state["u_queue"]
        x, u_act = state["x"], state["u_act"]
        for _ in range(self.substeps):
            u_act = u_act + self.alpha * (u_cmd - u_act)
            x = rk4(fc, x, u_act, self.dt / self.substeps)
        return dict(x=x, t=state["t"] + 1, u_act=u_act, u_queue=queue)
