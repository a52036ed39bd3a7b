"""The roofline probe of the port (`gpmpc_tpu_torch/roofline.py`,
`ops/cuda_chain.py`) against the JAX package on the CPU.

The Pallas bodies of `scripts/bench_roofline.py` are closures inside its
`main` and cannot be imported; what they compute is
`0.5 * _mm(a, a) + 0.5 * a` chained with `gpmpc_tpu.ops.pallas_ocp._mm`, so
that chain is the reference here. Inputs are the reference's data
(`eye + 0.05 * normal`, numpy seed 0). The chain leaves float32 after some ten
rounds, so values are compared after 4 rounds, and after 200 rounds only where
they are non-finite.

Tolerances: float32 rows 1e-5 relative to max(1, |ref|) (another summation
order); the bf16 row 2 bf16 ulps of max(1, |ref|) (both sides round every
product and every partial sum to bf16 in the same order, so they are expected
to agree exactly).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.ops.pallas_ocp import _mm as j_mm
from gpmpc_tpu_torch import roofline
from gpmpc_tpu_torch.ops import cuda_chain
from tests._torch_threads import _one_thread  # noqa: F401


N_ROUNDS = 4
TILES, STAGES = 2, 3
BF16_ULP = 2.0**-8  # spacing of bf16 values in [1, 2)


def jax_chain(x, n_chain):
    """x (tiles, T, N, N, L) -> the chain with the JAX package's `_mm`."""
    one = lambda a: 0.5 * j_mm(a, a) + 0.5 * a  # noqa: E731
    step = jax.vmap(jax.vmap(one))

    @jax.jit
    def run(acc):
        return jax.lax.fori_loop(0, n_chain, lambda i, a: step(a).astype(a.dtype), acc)

    return np.asarray(run(x).astype(jnp.float32))


def lanes_data(lanes, pad=False):
    mats = roofline.reference_mats(TILES * lanes, STAGES)
    if pad:
        mats = roofline.pad16_mats(mats, STAGES)
    return roofline.to_lanes(torch.as_tensor(mats), lanes)


CASES = {
    "lanes_chain": (cuda_chain.lanes_chain, cuda_chain.lanes_chain_plain, 128, False, torch.float32),
    "lanes_chain_bf16": (cuda_chain.lanes_chain_bf16, cuda_chain.lanes_chain_bf16_plain, 256, False,
                         torch.bfloat16),
    "lanes_chain_16": (cuda_chain.lanes_chain_16, cuda_chain.lanes_chain_16_plain, 128, True,
                       torch.float32),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_chain_matches_jax_mm_chain(name):
    wrapper, plain, lanes, pad, dtype = CASES[name]
    x = lanes_data(lanes, pad).to(dtype)
    assert x.shape == (TILES, STAGES, 16 if pad else 12, 16 if pad else 12, lanes)
    ref = jax_chain(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32), N_ROUNDS)
    out = plain(x, N_ROUNDS)
    assert out.dtype == dtype and out.shape == x.shape
    tol = 2 * BF16_ULP if dtype == torch.bfloat16 else 1e-5
    scale = np.maximum(1.0, np.abs(ref))
    assert np.isfinite(ref).all() and 1.0 < np.abs(ref).max() < 10.0
    assert float(np.max(np.abs(out.float().numpy() - ref) / scale)) <= tol
    # on CPU tensors the wrapper is the plain version, and counts no launch
    before = wrapper.launches
    assert torch.equal(wrapper(x, N_ROUNDS), out)
    assert wrapper.launches == before


def test_padded_chain_keeps_the_identity_pad_and_the_12x12_block():
    x16 = lanes_data(128, pad=True)
    out16 = cuda_chain.lanes_chain_16_plain(x16, N_ROUNDS)
    out12 = cuda_chain.lanes_chain_plain(lanes_data(128), N_ROUNDS)
    np.testing.assert_allclose(out16[:, :, :12, :12].numpy(), out12.numpy(), rtol=1e-6, atol=1e-6)
    eye = torch.eye(4)[None, None, :, :, None].expand(TILES, STAGES, 4, 4, 128)
    assert torch.equal(out16[:, :, 12:, 12:], eye)
    assert float(out16[:, :, :12, 12:].abs().max()) == 0.0


def test_200_rounds_agree_in_where_they_are_non_finite():
    x = lanes_data(128)[:1]
    ref = jax_chain(jnp.asarray(x.numpy()), roofline.N_CHAIN)
    out = cuda_chain.lanes_chain_plain(x, roofline.N_CHAIN).numpy()
    finite = np.isfinite(ref)
    assert 0.0 < finite.mean() < 0.5  # most scenarios left float32, a few converged
    assert np.array_equal(np.isfinite(out), finite)
    np.testing.assert_allclose(out[finite], ref[finite], atol=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = lanes_data(128)
    with pytest.raises(TypeError, match="bfloat16"):
        cuda_chain.lanes_chain_bf16(x, 1)
    with pytest.raises(ValueError, match="shape"):
        cuda_chain.lanes_chain_16(x, 1)
    with pytest.raises(ValueError, match="n_chain"):
        cuda_chain.lanes_chain(x, -1)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_chain.lanes_chain(x.transpose(0, 1).contiguous().transpose(0, 1), 1)


def test_roofline_rows_compute_the_same_chain():
    """The two library rows against the lanes row on the same scenarios:
    `torch_batched` on (B, T, 12, 12) and `tc_blockdiag` on ten scenarios per
    128 x 128 operand."""
    mats = torch.as_tensor(roofline.reference_mats(TILES * 128, STAGES))
    ref = roofline.from_lanes(cuda_chain.lanes_chain_plain(roofline.to_lanes(mats), N_ROUNDS))
    batched = roofline.torch_batched_chain(mats, N_ROUNDS)
    np.testing.assert_allclose(batched.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    packed, mask = roofline.pack_blockdiag(mats[:20])
    assert packed.shape == (2, STAGES, 128, 128) and int(mask.sum()) == 10 * 144
    assert torch.equal(roofline.unpack_blockdiag(packed), mats[:20])
    blockdiag = roofline.unpack_blockdiag(roofline.tc_blockdiag_chain(packed, mask, N_ROUNDS))
    np.testing.assert_allclose(blockdiag.numpy(), ref[:20].numpy(), rtol=1e-5, atol=1e-5)


def test_reference_sizes_and_flop_count():
    assert (roofline.B, roofline.T, roofline.T_PAD, roofline.N_CHAIN) == (1280, 25, 12, 200)
    assert roofline.useful_flops(roofline.T, roofline.N_CHAIN) == 2.0 * 1280 * 25 * 12**3 * 200
    mats = roofline.reference_mats(4, 2)
    rng = np.random.default_rng(0)
    want = (np.eye(12) + 0.05 * rng.normal(size=(4, 2, 12, 12))).astype(np.float32)
    assert np.array_equal(mats, want)


def test_roofline_rows_are_device_times_only():
    with pytest.raises(ValueError, match="not a CUDA device"):
        next(roofline.iter_rows("cpu"))


SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on sm_90


@pytest.mark.parametrize("kind,L", [(kind, L) for kind in ("f32", "bf16")
                                    for L in (2, 40, 64, 96, 128, 192, 256, 1280)])
def test_chain_geometry_tiles_every_slot_once(kind, L):
    """Kernels 7 and 8: the blocks of a (tile, stage) pair cover its slots
    (L in float32, L / 2 in packed bf16) once, each block at most the
    kernel's width, with one 12 x 12 buffer of 32-bit values a slot."""
    g = cuda_chain.chain_geometry(kind, L)
    slots = L // 2 if kind == "bf16" else L
    assert slots % g.slots_per_block == 0 and g.slots_per_block * g.slices == slots
    assert 1 <= g.slots_per_block <= cuda_chain.CHAIN_SLOTS
    assert g.shared_bytes == 4 * 12 * 12 * g.slots_per_block <= SMEM_LIMIT
    # the widest block that divides the slots and fits
    assert all(slots % w or w > cuda_chain.CHAIN_SLOTS
               for w in range(g.slots_per_block + 1, slots + 1))
    tiles, T = 3, 25
    assert g.blocks(tiles * T) == tiles * T * g.slices


def test_chain_slots_is_the_kernels_launch_bound():
    """CHAIN_SLOTS mirrors the one constant of csrc/lanes_chain.cu that sets
    chain_kernel's block width and launch bound."""
    text = (Path(cuda_chain.__file__).parents[1] / "csrc" / "lanes_chain.cu").read_text()
    assert re.findall(r"constexpr int kChainSlots = (\d+);", text) == [str(cuda_chain.CHAIN_SLOTS)]
    assert "__launch_bounds__(kChainSlots, kChainMinBlocks)" in text


def test_chain_geometry_at_the_probe_fills_the_card_in_one_wave():
    """At the probe's size both kernels launch more blocks than the H100 has
    SMs (132), and few enough warps that one wave holds them all."""
    for kind, lanes in (("f32", roofline.LANES), ("bf16", 2 * roofline.LANES)):
        g = cuda_chain.chain_geometry(kind, lanes)
        blocks = g.blocks(roofline.B // lanes * roofline.T)
        assert blocks >= 132
        warps = blocks * -(-g.slots_per_block // 32)
        assert warps == (1000 if kind == "f32" else 500)


@pytest.mark.parametrize("kind,L,match", [("bf16", 7, "odd tile width"),
                                          ("bf16", 1, "odd tile width"),
                                          ("f32", 0, "positive"), ("f16", 8, "kind")])
def test_chain_geometry_refuses_what_no_kernel_takes(kind, L, match):
    with pytest.raises(ValueError, match=match):
        cuda_chain.chain_geometry(kind, L)


@pytest.mark.parametrize("name,kind,lanes", [("lanes_chain", "f32", 128),
                                             ("lanes_chain", "f32", 40),
                                             ("lanes_chain_bf16", "bf16", 256),
                                             ("lanes_chain_bf16", "bf16", 192)])
def test_wrappers_launch_with_chain_geometry(monkeypatch, name, kind, lanes):
    """On the kernel route the wrapper hands the launcher `chain_geometry`'s
    numbers and counts one launch (the launch itself stubbed: no card here)."""
    calls = []
    monkeypatch.setattr(cuda_chain, "route", lambda device: "kernel")
    monkeypatch.setattr(cuda_chain._build, "launch", lambda entry, *a: calls.append((entry, a)))
    monkeypatch.setattr(cuda_chain._build, "stream_handle", lambda device: 0)
    wrapper = getattr(cuda_chain, name)
    x = lanes_data(lanes).to(torch.bfloat16 if kind == "bf16" else torch.float32)
    before = wrapper.launches
    out = wrapper(x, 3)
    assert out.shape == x.shape and wrapper.launches == before + 1
    (entry, args), = calls
    assert entry == name + "_launch"
    assert args[2:5] == (TILES * STAGES, lanes, 3)
    assert args[5:8] == tuple(cuda_chain.chain_geometry(kind, lanes)) and args[8] == 0
