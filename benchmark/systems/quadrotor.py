"""The quadrotor's plant and prior model in the program
(`gpmpc_tpu_torch.envs.drone`, `models.symbolic.symbolic_attitude`): the
family's module of the system under test (`benchmark/systems/<family>.py`),
found by the configuration's `family`."""

from __future__ import annotations

import torch


def plant(config: dict):
    """The plant's parameters (`envs.drone.EnvParams`) of the configuration,
    without process noise."""
    from gpmpc_tpu_torch.envs import drone
    from gpmpc_tpu_torch.models.quadrotor import QuadrotorParams

    p = config["plant"]
    return drone.EnvParams(
        params=QuadrotorParams.from_dict(p["params"]), dt=float(config["dt"]),
        n_steps=int(p["n_steps"]), sim_substeps=int(p["sim_substeps"]),
        traj_amplitude=float(p["traj_amplitude"]), traj_height=float(p["traj_height"]),
        rotor_tau=float(p["rotor_tau"]), att_tau=float(p["att_tau"]),
        drag_lin=float(p["drag_lin"]), drag_quad=float(p["drag_quad"]),
        delay_steps=int(p["delay_steps"]), noise_std=0.0)


def prior_model(config: dict):
    """The controller's prior model from the configuration's prior
    coefficients."""
    from gpmpc_tpu_torch.models.symbolic import symbolic_attitude

    return symbolic_attitude(dt=float(config["dt"]), params=dict(config["prior_params"]))


def trajectory(env_p):
    """(N, 12) the reference the controller tracks, as a host array."""
    from gpmpc_tpu_torch.envs import drone

    return drone.make_trajectory(env_p, "cpu").numpy()


def initial_plant(env_p, x0: torch.Tensor):
    """The plant's state at an episode's start from the initial states x0
    (B, 12): the actuators and the delay queue at hover."""
    from gpmpc_tpu_torch.envs import drone

    B, dev = x0.shape[0], x0.device
    hover = drone.hover_input(env_p.params, dev)
    return drone.EnvState(x=x0.clone(), t=torch.zeros(B, dtype=torch.int32, device=dev),
                          u_act=hover.expand(B, 4).clone(),
                          u_queue=hover.expand(B, env_p.delay_steps, 4).clone())


def plant_step(env_p, params: torch.Tensor, env_state, u: torch.Tensor):
    """One control step of every scenario with its own coefficients params
    (B, 8): (plant state, observations). The program's function is looked up
    at each call."""
    from gpmpc_tpu_torch.envs import drone

    env_state, obs, *_ = drone.env_step_dynamic(env_p, params, env_state, u)
    return env_state, obs
