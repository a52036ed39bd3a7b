"""The step's variance and tightening options of the port (`control/gpmpc.py::
gp_variances(bf16=)`, `batched_variances(backend=, bf16=)`,
`batched_prepare_step(var_backend=, var_bf16=, tighten_backend=)`, and
`parallel/batch.py::batched_gpmpc_step` with them) against the JAX package,
on the committed benchmark GPs and seeded numpy inputs, in float32 on both
sides.

Tolerances:
  * bf16 variances: per query, 16 float32 ulps of its own error scale
    s = sum_j |(k_bf W_bf)_j| |k_j| (the rounded operands' products are exact
    in float32 on both sides; their sums run in another order, and XLA's CPU
    dot of bfloat16 operands lands up to ~7.5 such ulps from the float64
    value of the same rounded form); the port within 2 of them of that
    float64 value.
  * The preparation at every var_backend x tighten_backend pair against the
    reference's with the same options (its Pallas branches in interpret
    mode): rtol 1e-5 and atol 2e-5 on every output, the reference's own bars
    for its two kernels' branches taken together (tests/test_pallas_gp.py:114,
    rtol 1e-5 and atol 1e-6; tests/test_pallas_tighten.py:82-86, atol 2e-5).
  * The lanes step with the options against the reference's
    `batched_select_action_lanes(interpret=True)`: actions 2e-4 absolute
    (tests/test_torch_sqp_lanes.py's bar).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control import gpmpc as j_gpmpc
from gpmpc_tpu.control import mpc as j_mpc
from gpmpc_tpu.control.gpmpc import GPMPC as JGPMPC
from gpmpc_tpu.envs.drone import make_trajectory as j_make_trajectory, EnvParams as JEnvParams
from gpmpc_tpu.gp.exact_gp import GPHypers as JGPHypers
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.control.mpc import MpcState
from gpmpc_tpu_torch.gp.exact_gp import softplus
from gpmpc_tpu_torch.gp.kernels import se_kernel
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym
from gpmpc_tpu_torch.parallel.batch import batched_gpmpc_step
from tests._torch_threads import _one_thread  # noqa: F401

F32 = np.float32
HYPERS = ("raw_lengthscale", "raw_outputscale", "raw_noise")
ULP = 2.0**-23
T, B = 6, 3


def gp_leaves(family: str, population: int = 0) -> dict:
    with np.load(convert.bench_gp_path(family)) as f:
        d = {k: np.asarray(v) for k, v in f.items()}
    if population:
        rng = np.random.default_rng(5)
        d = {k: np.repeat(v[None], population, axis=0) for k, v in d.items()}
        d["alpha_s"] = (d["alpha_s"] * (1.0 + 0.3 * rng.normal(size=d["alpha_s"].shape))).astype(F32)
        for k in HYPERS:
            d[k] = (d[k] + 0.1 * rng.normal(size=d[k].shape)).astype(F32)
    return d


def jax_gp(d) -> j_gpmpc.GpModel:
    leaf = lambda k: jnp.asarray(d[k])  # noqa: E731
    return j_gpmpc.GpModel(
        Z=leaf("Z"), y=leaf("y"), mask=leaf("mask"), hypers=JGPHypers(*[leaf(k) for k in HYPERS]),
        Zs=leaf("Zs"), alpha_s=leaf("alpha_s"), var_Z=leaf("var_Z"), var_mat=leaf("var_mat"),
        var_mask=leaf("var_mask"), trained=jnp.asarray(d["trained"], bool),
    )


def queries(d, n: int, seed: int = 0) -> np.ndarray:
    """(G, n, D) queries around each GP's first variance-form point."""
    rng = np.random.default_rng(seed)
    G, _, D = d["var_Z"].shape
    return (d["var_Z"][:, :1] + rng.normal(0, 0.3, (G, n, D))).astype(F32)


def bf16_scale_and_value(gp, z: torch.Tensor):
    """Per query: the error scale sum_j |(k_bf W_bf)_j| |k_j| and the float64
    value of the bf16 form (k and W rounded to bfloat16, k in float32 as the
    second factor), (G, N) each."""
    ell = softplus(gp.hypers.raw_lengthscale)
    sf2 = softplus(gp.hypers.raw_outputscale)
    scale, value = [], []
    for i in range(z.shape[0]):
        k = (se_kernel(z[i], gp.var_Z[i], ell[i], sf2[i]) * gp.var_mask[i]).double()
        kb = k.float().bfloat16().double()
        Wb = gp.var_mat[i].bfloat16().double()
        scale.append(((kb.abs() @ Wb.abs()) * k.abs()).sum(-1))
        value.append(torch.clamp_min(sf2[i].double() - ((kb @ Wb) * k).sum(-1), 1e-12))
    return torch.stack(scale).numpy(), torch.stack(value).numpy()


@pytest.mark.parametrize("family", ["quadrotor", "twolink"], ids=["G3-D3", "G2-D6"])
def test_gp_variances_bf16_matches_jax(family):
    """bf16=True at G = 3, D = 3 (the quadrotor's GPs) and G = 2, D = 6 (the
    two-link arm's) on 400 queries each: the port within 16 ulps of each
    query's error scale of JAX's, within 2 of the float64 value of the same
    rounded form, and away from the float32 variances (the option acts)."""
    d = gp_leaves(family)
    gp_t = convert.gp_model_from_numpy(d, "cpu")
    z = queries(d, 400)
    got = t_gpmpc.gp_variances(gp_t, torch.as_tensor(z), bf16=True).numpy()
    want = np.asarray(j_gpmpc.gp_variances(jax_gp(d), jnp.asarray(z), bf16=True), F32)
    scale, value = bf16_scale_and_value(gp_t, torch.as_tensor(z))
    assert got.shape == want.shape == z.shape[:2]
    np.testing.assert_array_less(np.abs(got - want), 16 * ULP * scale + 1e-12)
    np.testing.assert_array_less(np.abs(got - value), 2 * ULP * scale + 1e-12)
    f32 = t_gpmpc.gp_variances(gp_t, torch.as_tensor(z)).numpy()
    assert np.abs(got - f32).max() > 1e-6


def test_population_variances_bf16_match_jax():
    """A population of two quadrotor GPs: `batched_variances(bf16=True)`
    takes each scenario's own bf16 form, whatever the backend, as the
    reference's vmapped branch does."""
    d = gp_leaves("quadrotor", population=2)
    gp_t = convert.gp_model_from_numpy(d, "cpu")
    rng = np.random.default_rng(2)
    z = (d["var_Z"][0][:, None, :1] + rng.normal(0, 0.3, (3, 2, 5, 3))).astype(F32)
    want = np.asarray(j_gpmpc.batched_variances(jax_gp(d), jnp.asarray(z), backend="xla",
                                                bf16=True), F32)
    for backend in ("auto", "pallas", "xla"):
        got = t_gpmpc.batched_variances(gp_t, torch.as_tensor(z), backend=backend, bf16=True)
        assert got.shape == (3, 2, 5)
        per_scenario = [bf16_scale_and_value(
            type(gp_t)(*[type(v)(*[h[s] for h in v]) if isinstance(v, tuple) else v[s]
                         for v in gp_t]), torch.as_tensor(z[:, s]))[0] for s in range(2)]
        scale = np.stack(per_scenario, axis=1)
        np.testing.assert_array_less(np.abs(got.numpy() - want), 16 * ULP * scale + 1e-12)


def test_kernel_branch_ignores_bf16_and_unknown_backends_raise():
    """`bf16` acts on the plain form only (the reference's Pallas branch
    ignores it; there is no bf16 kernel); a backend name outside the
    reference's three raises."""
    d = gp_leaves("quadrotor")
    gp_t = convert.gp_model_from_numpy(d, "cpu")
    z = torch.as_tensor(queries(d, 12)[:, None])  # (G, 1, 12, D)
    a = t_gpmpc.batched_variances(gp_t, z, backend="pallas")
    b = t_gpmpc.batched_variances(gp_t, z, backend="pallas", bf16=True)
    assert torch.equal(a, b)
    assert not torch.equal(t_gpmpc.batched_variances(gp_t, z, backend="xla", bf16=True),
                           t_gpmpc.batched_variances(gp_t, z, backend="xla"))
    with pytest.raises(ValueError, match="var_backend"):
        t_gpmpc.batched_variances(gp_t, z, backend="tpu")
    with pytest.raises(ValueError, match="tighten_backend"):
        t_gpmpc.batched_prepare_step(*_prepare_inputs()[1], tighten_backend="scan")


@lru_cache(maxsize=None)
def _controllers():
    prior = reference_prior_dict()
    traj = np.asarray(j_make_trajectory(JEnvParams.default()), F32)
    kw = dict(horizon=T, q_mpc=Q_MPC, r_mpc=R_MPC, prob=0.95, sqp_iters=2, qp_iters=4)
    jc = JGPMPC(j_sym(dt=0.02, params=prior), traj, prior, **kw)
    tc = t_gpmpc.GPMPC(t_sym(dt=0.02, params=prior), traj, prior, device="cpu", **kw)
    return traj, jc, tc


def _prepare_inputs():
    """(JAX inputs, port inputs) of a prepare step: B = 3 perturbed warm
    starts at traj_step 1, the benchmark GP."""
    traj, jc, tc = _controllers()
    rng = np.random.default_rng(1)
    obs = (traj[:B] + 0.01 * rng.normal(size=(B, 12))).astype(F32)
    X = (obs[:, None, :] + 0.05 * rng.normal(size=(B, T + 1, 12))).astype(F32)
    U = (np.asarray([0.3234, 0, 0, 0], F32) + 0.05 * rng.normal(size=(B, T, 4))).astype(F32)
    d = gp_leaves("quadrotor")
    st_j = j_mpc.MpcState(traj_step=jnp.ones(B, jnp.int32), X_warm=jnp.asarray(X),
                          U_warm=jnp.asarray(U))
    st_t = MpcState(traj_step=torch.ones(B, dtype=torch.int32), X_warm=torch.as_tensor(X),
                    U_warm=torch.as_tensor(U))
    return ((jc.model, jc.consts, jax_gp(d), st_j, jnp.asarray(obs)),
            (tc.model, tc.consts, convert.gp_model_from_numpy(d, "cpu"), st_t, torch.as_tensor(obs)))


@lru_cache(maxsize=None)
def _reference_prepare(var_backend: str, tighten_backend: str):
    """The reference's preparation on the CPU with its Pallas branches in
    interpret mode (where "auto" takes the Pallas tightening and the XLA
    variances), as a list of float32 arrays."""
    args = _prepare_inputs()[0]
    out = j_gpmpc.batched_prepare_step(*args, var_backend=var_backend,
                                       tighten_backend=tighten_backend, interpret=True)
    return [np.asarray(leaf, F32) for leaf in jax.tree.leaves(out)]


# the port's choice on the CPU for "auto": the plain variances and the tightening kernel's
# wrapper (its plain version on CPU tensors), the reference's with interpret=True
EFFECTIVE = {"var": {"auto": "xla", "pallas": "pallas", "xla": "xla"},
             "tighten": {"auto": "pallas", "pallas": "pallas", "xla": "xla"}}


@pytest.mark.parametrize("tighten_backend", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("var_backend", ["auto", "pallas", "xla"])
def test_batched_prepare_step_options_match_jax(var_backend, tighten_backend):
    """Every var_backend x tighten_backend pair of the port's preparation
    against the reference's with the same effective choices: the tightened
    boxes, reference window, warm starts and clamp fraction."""
    want = _reference_prepare(EFFECTIVE["var"][var_backend],
                              EFFECTIVE["tighten"][tighten_backend])
    out = t_gpmpc.batched_prepare_step(*_prepare_inputs()[1], var_backend=var_backend,
                                       tighten_backend=tighten_backend)
    got = [out[0], *out[1], out[2], out[3], out[4]]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=2e-5)
    lx = got[1].numpy()
    assert float(np.abs(lx[:, 1:] - np.asarray(_controllers()[2].consts.mpc.lx)).max()) > 1e-4


def test_lanes_step_options_match_jax():
    """`batched_gpmpc_step(backend="lanes", var_backend="xla", var_bf16=True,
    tighten_backend="xla")` against the reference's lanes step with the
    same variance options (interpret mode), one step from warm starts with
    the tightening on; on the xla path the options change nothing, as in the
    reference, whose vmapped `select_action` ignores them."""
    traj, jc, tc = _controllers()
    (_, _, gp_j, st_j, obs_j), (model_t, consts_t, gp_t, st_t, obs_t) = _prepare_inputs()
    cfg_t = tc.cfg._replace(qp_mehrotra=True, qp_tol=None)
    cfg_j = jc.cfg._replace(qp_mehrotra=True, qp_tol=None)
    u_j, _, _ = j_gpmpc.batched_select_action_lanes(
        jc.model, cfg_j, jc.consts, gp_j, st_j, obs_j, interpret=True, var_backend="xla",
        var_bf16=True)
    u_t, st_t, info = batched_gpmpc_step(
        model_t, cfg_t, consts_t, gp_t, st_t, obs_t, backend="lanes", lanes=B,
        var_backend="xla", var_bf16=True, tighten_backend="xla")
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j, F32), atol=2e-4)
    np.testing.assert_allclose(info.clamp_frac.numpy(), 0.0)
    st0 = MpcState(traj_step=torch.ones(B, dtype=torch.int32), X_warm=st_t.X_warm,
                   U_warm=st_t.U_warm)
    plain = batched_gpmpc_step(model_t, cfg_t, consts_t, gp_t, st0, obs_t, backend="xla")[0]
    opts = batched_gpmpc_step(model_t, cfg_t, consts_t, gp_t, st0, obs_t, backend="xla",
                              var_backend="pallas", var_bf16=True, tighten_backend="xla")[0]
    assert torch.equal(plain, opts)
