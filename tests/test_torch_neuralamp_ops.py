"""The PyTorch port's NeuralAmp ops (``ops/neuralamp.py``) against the JAX
package's, on the CPU at toy size (T = 4, B = 64, C = 16, L = 4, H = 16),
from seeded NumPy inputs.

Tolerances: the copied host functions, the f64 goldens and the cast
weights (int8 values and scales too) bit for bit; the f32 TCN and LSTM
blocks within 1e-5 of the JAX block's peak over 3 carried blocks (the
port sums in full FP32 in another order, and its LSTM adds the input term
and takes the output GEMV outside the step loop); the bf16 LSTM within
1e-3; the bf16 and int8 TCN blocks against the f64 golden at the
benchmark's tolerance (one f32 ulp can move a bf16 activation by a whole
bf16 step), and int8's quantized first layer bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuaudiobench_tpu.ops import neuralamp as jna
from gpuaudiobench_tpu_torch.harness.graph import CapturedBlock
from gpuaudiobench_tpu_torch.models.neuralamp import TOLERANCE
from gpuaudiobench_tpu_torch.ops import neuralamp as na

CPU = torch.device("cpu")
T, B, C, L, H = 4, 64, 16, 4, 16


def _x(seed=5, t=T, b=B):
    return np.random.default_rng(seed).uniform(-1, 1, (t, b)).astype(
        np.float32)


def _rel(ours, ref):
    o = ours.float().numpy() if isinstance(ours, torch.Tensor) else ours
    r = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(o, np.float64) - r).max()
                 / max(np.abs(r).max(), 1e-12))


def test_constants_are_the_references():
    assert na.KERNEL == jna.KERNEL
    assert na.LSTM_STEADY_SAMPLES == jna.LSTM_STEADY_SAMPLES


@pytest.mark.parametrize("layers", [1, 4, 10, 12])
def test_schedules_equal_the_reference(layers):
    assert na.dilations(layers) == jna.dilations(layers)
    assert na.context_lengths(layers) == jna.context_lengths(layers)
    assert na.receptive_field(layers) == jna.receptive_field(layers)
    for b in (16, 64, 512, 1000):
        assert na.steady_blocks(layers, b) == jna.steady_blocks(layers, b)
        assert na.lstm_steady_blocks(b) == jna.lstm_steady_blocks(b)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("channels,layers", [(16, 4), (128, 10), (512, 12)])
def test_param_bytes_equal_the_reference(dtype, channels, layers):
    assert (na.param_bytes(channels, layers, dtype)
            == jna.param_bytes(channels, layers, dtype))
    if dtype != "int8":
        assert (na.lstm_param_bytes(channels, dtype)
                == jna.lstm_param_bytes(channels, dtype))


@pytest.mark.parametrize("seed", [0, 42, 7])
def test_seeded_weights_equal_the_reference(seed):
    for ours, ref in ((na.init_params(seed, C, L), jna.init_params(seed, C, L)),
                      (na.init_lstm_params(seed, H),
                       jna.init_lstm_params(seed, H))):
        assert list(ours) == list(ref)
        for k in ours:
            assert np.asarray(ours[k]).dtype == np.asarray(ref[k]).dtype, k
            np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_init_tails_equal_the_reference(dtype):
    ours = na.init_tails(T, C, L, dtype)
    ref = jna.init_tails(T, C, L, dtype)
    want = torch.float32 if dtype == "f32" else torch.bfloat16
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert o.dtype == want and r.dtype == np.dtype(jnp.bfloat16 if
                                                       dtype != "f32"
                                                       else np.float32)
        assert tuple(o.shape) == r.shape and not o.any()


@pytest.mark.parametrize("k", [1, 3, 7])
def test_tcn_goldens_equal_the_reference(k):
    p, x = na.init_params(3, C, L), _x()
    np.testing.assert_array_equal(na.tcn_reference(x, k, p, L),
                                  jna.tcn_reference(x, k, p, L))
    tails = tuple(np.full((T, ctx, C), 0.25) for ctx in na.context_lengths(L))
    y, t2 = na.tcn_block_f64(x, tails, p, L)
    jy, jt2 = jna.tcn_block_f64(x, tails, p, L)
    np.testing.assert_array_equal(y, jy)
    for a, b in zip(t2, jt2):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [1, 3, 12])
def test_lstm_goldens_equal_the_reference(k):
    p, x = na.init_lstm_params(3, H), _x()
    np.testing.assert_array_equal(na.lstm_reference(x, k, p),
                                  jna.lstm_reference(x, k, p))
    h = c = np.full((T, H), 0.1)
    for o, r in zip(na.lstm_block_f64(x, h, c, p),
                    jna.lstm_block_f64(x, h, c, p)):
        np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_cast_params_equal_the_reference(dtype):
    p = na.init_params(42, C, L)
    ours, ref = na.cast_params(p, dtype, CPU), jna.cast_params(p, dtype)
    assert sorted(ours) == sorted(ref)
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16",
             torch.int8: "int8"}
    for k, r in ref.items():
        assert names[ours[k].dtype] == str(r.dtype), k
        np.testing.assert_array_equal(ours[k].float().numpy(),
                                      np.asarray(r, np.float32), err_msg=k)
    if dtype == "int8":
        for l in range(L):
            # each tap matrix column-major: C_in contiguous
            assert ours[f"w{l}"][0].stride() == (1, C)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cast_lstm_params_equal_the_reference(dtype):
    p = na.init_lstm_params(42, H)
    ours, ref = na.cast_lstm_params(p, dtype, CPU), jna.cast_lstm_params(
        p, dtype)
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        assert str(ours[k].dtype).split(".")[-1] == str(r.dtype), k
        np.testing.assert_array_equal(ours[k].float().numpy(),
                                      np.asarray(r, np.float32), err_msg=k)


def _tcn_pair(dtype, blocks=3, seed=5):
    """(port outputs, JAX outputs, port tails, JAX tails) over ``blocks``
    carried blocks of the same input."""
    p, x = na.init_params(42, C, L), _x(seed)
    tp, jp = na.cast_params(p, dtype, CPU), jna.cast_params(p, dtype)
    tt = na.init_tails(T, C, L, dtype)
    jt = tuple(jnp.asarray(a) for a in jna.init_tails(T, C, L, dtype))
    ours, refs = [], []
    for _ in range(blocks):
        y, tt = na.tcn_block(torch.from_numpy(x), tt, tp, L, dtype)
        jy, jt = jna.tcn_block(jnp.asarray(x), jt, jp, layers=L, dtype=dtype)
        ours.append(y)
        refs.append(np.asarray(jy))
    return ours, refs, tt, jt, p, x


def test_f32_tcn_block_matches_the_reference():
    ours, refs, tt, jt, _, _ = _tcn_pair("f32")
    for y, r in zip(ours, refs):
        assert y.dtype == torch.float32 and y.shape == (T, B)
        assert _rel(y, r) <= 1e-5
    for a, b in zip(tt, jt):
        assert _rel(a, np.asarray(b)) <= 1e-5


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_low_precision_tcn_block_meets_its_golden(dtype):
    ours, refs, tt, _, p, x = _tcn_pair(dtype)
    for k, (y, r) in enumerate(zip(ours, refs), start=1):
        golden = na.tcn_reference(x, k, p, L)
        assert _rel(y, golden) <= TOLERANCE[("tcn", dtype)]
        assert _rel(r, golden) <= TOLERANCE[("tcn", dtype)]
        assert 1e-5 < _rel(y, golden)  # really reduced precision
    assert all(t.dtype == torch.bfloat16 for t in tt)


def test_int8_first_layer_is_the_references_bit_for_bit():
    """The first layer's quantized input, its scale and its int32 tap sums
    from the same bf16 activation: the port's ``quantize_activation`` and
    ``torch._int_mm`` against the JAX block's expressions
    (gpuaudiobench_tpu/ops/neuralamp.py:228-237)."""
    p, x = na.init_params(42, C, L), _x()
    tp, jp = na.cast_params(p, "int8", CPU), jna.cast_params(p, "int8")
    h = torch.tanh(torch.from_numpy(x)[..., None] * tp["w_in"]
                   + tp["b_in"]).to(torch.bfloat16)
    ext = torch.cat([torch.zeros((T, 2, C), dtype=torch.bfloat16), h], 1)
    q, s_a = na.quantize_activation(ext)
    q_acc, _ = na._int8_taps(ext, tp["w0"], 1, B)

    jext32 = jnp.asarray(ext.float().numpy()).astype(jnp.bfloat16).astype(
        jnp.float32)
    js = jnp.maximum(jnp.max(jnp.abs(jext32)), 1e-12) / 127.0
    jq = jnp.clip(jnp.round(jext32 / js), -127, 127).astype(jnp.int8)
    j_acc = sum(jnp.einsum("tsc,cd->tsd", jq[:, j:j + B], jp["w0"][j],
                           preferred_element_type=jnp.int32)
                for j in range(na.KERNEL))
    assert s_a.dtype == torch.float32 and float(s_a) == float(js)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q_acc.dtype == torch.int32
    np.testing.assert_array_equal(q_acc.numpy(), np.asarray(j_acc))


def _lstm_pair(dtype, blocks=3):
    p, x = na.init_lstm_params(42, H), _x()
    tp, jp = na.cast_lstm_params(p, dtype, CPU), jna.cast_lstm_params(p, dtype)
    th = tc = torch.zeros((T, H))
    jh = jc = jnp.zeros((T, H))
    out = []
    for _ in range(blocks):
        y, th, tc = na.lstm_block(torch.from_numpy(x), th, tc, tp, dtype)
        jy, jh, jc = jna.lstm_block(jnp.asarray(x), jh, jc, jp, dtype=dtype)
        out.append(((y, th, tc), (jy, jh, jc)))
    return out


@pytest.mark.parametrize("dtype,rel", [("f32", 1e-5), ("bf16", 1e-3)])
def test_lstm_block_matches_the_reference(dtype, rel):
    for ours, refs in _lstm_pair(dtype):
        for what, o, r in zip(("y", "h", "c"), ours, refs):
            assert o.dtype == torch.float32
            assert _rel(o, np.asarray(r)) <= rel, what


def test_lstm_block_does_not_write_its_inputs():
    p = na.cast_lstm_params(na.init_lstm_params(1, H), "f32", CPU)
    x = torch.from_numpy(_x())
    h, c = torch.full((T, H), 0.3), torch.full((T, H), -0.2)
    before = [t.clone() for t in (x, h, c, *p.values())]
    y, h2, c2 = na.lstm_block(x, h, c, p)
    for a, b in zip(before, (x, h, c, *p.values())):
        assert torch.equal(a, b)
    assert not torch.equal(h2, h)


def test_lstm_runner_on_the_cpu_is_the_eager_block():
    p = na.cast_lstm_params(na.init_lstm_params(1, H), "bf16", CPU)
    x = torch.from_numpy(_x())
    h = c = torch.zeros((T, H))
    run = na.lstm_runner(p, "bf16", x, h, c)
    want = na.lstm_block(x, h, c, p, "bf16")
    replays = na.GRAPH_REPLAYS["lstm_block"]
    for got in (run(), run(x, h, c)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert na.GRAPH_REPLAYS["lstm_block"] == replays  # no graph here


def test_lstm_runner_has_no_graph_off_cuda():
    p = na.cast_lstm_params(na.init_lstm_params(1, H), "f32", CPU)
    meta = [torch.empty(s, device="meta") for s in ((T, B), (T, H), (T, H))]
    with pytest.raises(ValueError, match="no CUDA graph"):
        na.lstm_runner(p, "f32", *meta)


def test_captured_block_raises_on_the_cpu():
    """No graph on the CPU, and no eager stand-in for one."""
    with pytest.raises(ValueError, match="CUDA device"):
        CapturedBlock(lambda x: (x * 2,), [torch.ones(8)])
