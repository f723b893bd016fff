"""The port's sharded blocks (``gpuaudiobench_tpu_torch/parallel/
{fdtd,partconv,neuralamp}_sharded.py``) on 4 and 8 gloo ranks, each
against the port's single-device block on the CPU and against the JAX
package's sharded block on a mesh of as many of the conftest's CPU
devices, from seeded NumPy inputs, streamed over a few blocks where the
block carries state.

Tolerances: the FDTD block within 1e-6 absolute of either
(``tests/test_multichip.py:123``'s); PartConv, the TCN and the LSTM
within 1e-5 of the peak of the block they are held against (the sums of
a psum or a column-split GEMM run in another order; two FFT libraries
round differently). One spawn a world size, each with a hard timeout.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from gpuaudiobench_tpu.ops import neuralamp as jna
from gpuaudiobench_tpu.ops import partconv as jpc
from gpuaudiobench_tpu.parallel.fdtd_sharded import (
    make_fdtd_sharded_block as jax_fdtd,
)
from gpuaudiobench_tpu.parallel.neuralamp_sharded import (
    make_neuralamp_lstm_tp_block as jax_lstm,
)
from gpuaudiobench_tpu.parallel.neuralamp_sharded import (
    make_neuralamp_tp_block as jax_tcn,
)
from gpuaudiobench_tpu.parallel.partconv_sharded import (
    make_partconv_sharded_block as jax_partconv,
)
from gpuaudiobench_tpu_torch.ops import fdtd3d as tfdtd
from gpuaudiobench_tpu_torch.ops import neuralamp as na
from gpuaudiobench_tpu_torch.ops import partconv as tpc
from gpuaudiobench_tpu_torch.parallel import ranks
from gpuaudiobench_tpu_torch.parallel.fdtd_sharded import (
    make_fdtd_sharded_block,
)
from gpuaudiobench_tpu_torch.parallel.launch import spmd
from gpuaudiobench_tpu_torch.parallel.partconv_sharded import (
    make_partconv_sharded_block,
)
from gpuaudiobench_tpu_torch.utils.data import generate_random_audio

SPAWN_TIMEOUT_S = 180
REL = 1e-5
WORLDS = [4, 8]
# PartConv: 2 tracks, B = 16, L = 128 (P = 8 partitions), P + 4 blocks.
PC_T, PC_B, PC_L = 2, 16, 128
# The TCN: 2 tracks x 32 samples, C = 16, 4 layers, 2 blocks; the LSTM:
# H = 16, 2 blocks of 32 samples (its gather runs every sample).
NA_T, NA_B, NA_C, NA_L, NA_H = 2, 32, 16, 4, 16


def _close(ours, ref, what, rel=REL):
    o, r = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert o.shape == r.shape, (what, o.shape, r.shape)
    peak = max(float(np.abs(r).max()), 1e-12)
    err = float(np.abs(o - r).max())
    assert err <= rel * peak, f"{what}: {err:.3g} > {rel:g} x {peak:.3g}"


def _inputs():
    g = np.random.default_rng(5)
    fdtd_x = generate_random_audio(4 * 16, 42).reshape(4, 16)
    ir = g.standard_normal((PC_T, PC_L)).astype(np.float32)
    pc_xs = [g.standard_normal((PC_T, PC_B)).astype(np.float32)
             for _ in range(PC_L // PC_B + 4)]
    na_xs = [g.uniform(-1, 1, (NA_T, NA_B)).astype(np.float32)
             for _ in range(2)]
    return {
        "fdtd": (fdtd_x,),
        "partconv": (ir, pc_xs),
        "tcn": (na.init_params(42, NA_C, NA_L), NA_L, na_xs),
        "lstm": (na.init_lstm_params(42, NA_H), na_xs),
    }


def _kinds(world):
    # 52 grid planes split over 4 ranks, not over 8.
    return ["fdtd", "partconv", "tcn", "lstm"] if world < 8 else [
        "partconv", "tcn", "lstm"]


@pytest.fixture(scope="module")
def port():
    """{(world, kind): result} of the port's sharded blocks, one spawn a
    world size."""
    inputs = _inputs()
    out = {}
    for world in WORLDS:
        kinds = _kinds(world)
        res = spmd(ranks.blocks_check, world, "cpu",
                   [(k, inputs[k]) for k in kinds], "cpu",
                   timeout_s=SPAWN_TIMEOUT_S)
        out.update({(world, k): r for k, r in zip(kinds, res)})
    return inputs, out


def _jmesh(world):
    return np.asarray(jax.devices()[:world]).reshape(world)


def _single(kind, inputs):
    """The port's single-device block on the CPU, streamed the same way."""
    cpu = torch.device("cpu")
    if kind == "fdtd":
        (x,) = inputs
        out, *_ = tfdtd.fdtd3d_block_field(torch.from_numpy(x),
                                           *tfdtd.zero_fields())
        return out.numpy()
    if kind == "partconv":
        ir, xs = inputs
        h_re, h_im = tpc.partition_spectra(torch.from_numpy(ir), PC_B)
        fdl = torch.zeros_like(h_re)
        f_re, f_im, prev, ys = fdl, fdl, torch.zeros((PC_T, PC_B)), []
        for x in xs:
            x = torch.from_numpy(x)
            y, f_re, f_im = tpc.partconv_block(x, prev, f_re, f_im, h_re,
                                               h_im)
            prev = x
            ys.append(y.numpy())
        return ys
    if kind == "tcn":
        params, layers, xs = inputs
        cp = na.cast_params(params, "f32", cpu)
        tails, ys = na.init_tails(NA_T, NA_C, layers), []
        for x in xs:
            y, tails = na.tcn_block(torch.from_numpy(x), tails, cp, layers)
            ys.append(y.numpy())
        return ys, [t.numpy() for t in tails]
    params, xs = inputs
    cp = na.cast_lstm_params(params, "f32", cpu)
    h = c = torch.zeros((NA_T, NA_H))
    ys = []
    for x in xs:
        y, h, c = na.lstm_block(torch.from_numpy(x), h, c, cp)
        ys.append(y.numpy())
    return ys, h.numpy(), c.numpy()


def _jax(kind, world, inputs):
    """The JAX package's sharded block on ``world`` CPU devices."""
    if kind == "fdtd":
        (x,) = inputs
        fn = jax_fdtd(JaxMesh(_jmesh(world), ("sp",)), axis="sp")
        return np.asarray(fn(jnp.asarray(x)))
    if kind == "partconv":
        ir, xs = inputs
        p = jpc.num_partitions(PC_L, PC_B)
        h_re, h_im = jpc.partition_spectra(jnp.asarray(ir), PC_B)
        fn = jax_partconv(JaxMesh(_jmesh(world), ("tp",)), p, axis="tp")
        fdl = jnp.zeros((PC_T, p, PC_B + 1), jnp.float32)
        f_re, f_im, prev, ys = fdl, fdl, jnp.zeros((PC_T, PC_B)), []
        for x in xs:
            y, f_re, f_im = fn(jnp.asarray(x), prev, f_re, f_im, h_re, h_im)
            prev = jnp.asarray(x)
            ys.append(np.asarray(y))
        return ys
    if kind == "tcn":
        params, layers, xs = inputs
        fn = jax_tcn(JaxMesh(_jmesh(world), ("tp",)), layers)
        cp = jna.cast_params(params, "f32")
        tails = tuple(jnp.asarray(a)
                      for a in jna.init_tails(NA_T, NA_C, layers))
        ys = []
        for x in xs:
            y, tails = fn(jnp.asarray(x), tails, cp)
            ys.append(np.asarray(y))
        return ys, [np.asarray(t) for t in tails]
    params, xs = inputs
    fn = jax_lstm(JaxMesh(_jmesh(world), ("tp",)))
    cp = jna.cast_lstm_params(params, "f32")
    h = c = jnp.zeros((NA_T, NA_H), jnp.float32)
    ys = []
    for x in xs:
        y, h, c = fn(jnp.asarray(x), h, c, cp)
        ys.append(np.asarray(y))
    return ys, np.asarray(h), np.asarray(c)


def _leaves(result):
    """(label, array) of a block's result: outputs, then carried state."""
    if isinstance(result, np.ndarray):
        return [("out", result)]
    if isinstance(result, list):
        return [(f"y{k}", y) for k, y in enumerate(result)]
    ys, *state = result
    leaves = [(f"y{k}", y) for k, y in enumerate(ys)]
    for k, s in enumerate(state):
        if isinstance(s, list):
            leaves += [(f"tail{j}", t) for j, t in enumerate(s)]
        else:
            leaves.append((("h", "c")[k], s))
    return leaves


CASES = [(w, k) for w in WORLDS for k in _kinds(w)]


@pytest.mark.parametrize("world,kind", CASES)
def test_sharded_block_matches_the_single_device_block(port, world, kind):
    inputs, results = port
    ref = _single(kind, inputs[kind])
    for (label, o), (_, r) in zip(_leaves(results[(world, kind)]),
                                  _leaves(ref)):
        if kind == "fdtd":
            np.testing.assert_allclose(o, r, rtol=0, atol=1e-6)
        else:
            _close(o, r, f"{kind} {label} on {world} ranks")


@pytest.mark.parametrize("world,kind", CASES)
def test_sharded_block_matches_the_jax_sharded_block(port, world, kind):
    inputs, results = port
    ref = _jax(kind, world, inputs[kind])
    ours = _leaves(results[(world, kind)])
    theirs = _leaves(ref)
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    for (label, o), (_, r) in zip(ours, theirs):
        if kind == "fdtd":
            np.testing.assert_allclose(o, r, rtol=0, atol=1e-6)
        else:
            _close(o, r, f"{kind} {label} on {world} ranks")


def _fake_mesh(n):
    return types.SimpleNamespace(axis_size=lambda axis: n,
                                 axis_index=lambda axis: 0)


def test_sharded_blocks_refuse_what_does_not_split():
    with pytest.raises(ValueError, match="grid 52 not divisible by 8"):
        make_fdtd_sharded_block(_fake_mesh(8), "sp")
    with pytest.raises(ValueError, match=r"partitions \(9\) not divisible"):
        make_partconv_sharded_block(_fake_mesh(8), 9, axis="tp")


def test_one_rank_blocks_run_without_a_process_group():
    """On one rank the sharded blocks are their single-device blocks' math
    (every collective the identity): bit for bit for PartConv's output."""
    inputs = _inputs()
    ys = ranks.partconv_blocks(*inputs["partconv"], device="cpu")
    for o, r in zip(ys, _single("partconv", inputs["partconv"])):
        np.testing.assert_array_equal(o, r)
