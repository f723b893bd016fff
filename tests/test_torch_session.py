"""The PyTorch port's DAWSessionMix (``models/session.py``) against the JAX
package's, on the CPU at toy size, from seeded NumPy inputs.

Tolerances: the console settings and the goldens bit for bit (both are
the same NumPy code); a session block's mix and carried state within
1e-5 of the JAX block's peak (the EQ is the plain cascade twin, the FFTs
and matmuls are another library's); the benchmark's own validation at
its 1e-3 contract.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpuaudiobench_tpu.config import BenchConfig as JaxConfig
from gpuaudiobench_tpu.models import session as jsession
from gpuaudiobench_tpu.ops import partconv as jops
from gpuaudiobench_tpu.utils.data import biquad_lowpass_coefficients
from gpuaudiobench_tpu_torch import cli
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
from gpuaudiobench_tpu_torch.models import session as tsession
from gpuaudiobench_tpu_torch.ops import iir as iir_ops
from gpuaudiobench_tpu_torch.ops import partconv as tops

CPU = torch.device("cpu")
REL = 1e-5


def _close(ours, ref, what, rel=REL):
    o = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    r = np.asarray(ref, np.float64)
    assert o.shape == r.shape, (what, o.shape, r.shape)
    peak = max(float(np.abs(r).max()), 1e-12)
    err = float(np.abs(o.astype(np.float64) - r).max())
    assert err <= rel * peak, f"{what}: {err:.3g} > {rel:g} x {peak:.3g}"


@pytest.mark.parametrize("tracks,seed", [(1, 42), (8, 42), (300, 7),
                                         (65536, 42)])
def test_session_mix_params_bit_for_bit(tracks, seed):
    ours = tsession.session_mix_params(tracks, seed)
    ref = jsession.session_mix_params(tracks, seed)
    for o, r in zip(ours, ref):
        assert o.dtype == r.dtype == np.float32
        np.testing.assert_array_equal(o, r)


def _console(t, b, stages, ir_len, seed=11):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((t, b)) * 0.5).astype(np.float32)
    coeffs = [biquad_lowpass_coefficients(0.25 - 0.0125 * s)
              for s in range(stages)]
    send, pan2 = tsession.session_mix_params(t, seed)
    ir = tsession.reverb_impulse_responses(2, ir_len, seed)
    return x, coeffs, send, pan2, ir


@pytest.mark.parametrize("k,clamp", [(1, None), (3, None), (7, None),
                                     (41, None), (41, 28), (28, 28)])
def test_session_reference_equals_the_reference(k, clamp):
    x, coeffs, send, pan2, ir = _console(4, 64, 4, 256)
    ours = tsession.session_reference(x, coeffs, send, pan2, ir,
                                      tsession.WET_GAIN, k, clamp=clamp)
    ref = jsession.session_reference(x, coeffs, send, pan2, ir,
                                     jsession.WET_GAIN, k, clamp=clamp)
    np.testing.assert_array_equal(ours, ref)


def test_clamped_golden_is_the_unclamped_one():
    """Past the clamp the stream is periodic: P + settle + 8 blocks
    (models/session.py) replay the same mix as the whole stream."""
    x, coeffs, send, pan2, ir = _console(4, 64, 4, 256)
    clamp = 4 + 16 + 8
    full = tsession.session_reference(x, coeffs, send, pan2, ir,
                                      tsession.WET_GAIN, clamp + 13)
    clamped = tsession.session_reference(x, coeffs, send, pan2, ir,
                                         tsession.WET_GAIN, clamp + 13,
                                         clamp=clamp)
    np.testing.assert_allclose(full, clamped, rtol=0, atol=1e-6)


def test_constants_are_the_references():
    assert tsession.WET_GAIN == jsession.WET_GAIN
    assert tsession._EQ_SETTLE_SAMPLES == jsession._EQ_SETTLE_SAMPLES
    assert tsession.DEFAULT_IR_LENGTH == jsession.DEFAULT_IR_LENGTH


@pytest.mark.parametrize("stages", [1, 4, 16])
def test_block_matches_the_reference_core(stages):
    """``session_block`` against ``make_session_core("xla", K)`` over
    P + 3 blocks of fresh input, carrying every state."""
    t, b, ir_len = 8, 64, 300
    rng = np.random.default_rng(stages)
    _, coeffs, send, pan2, ir = _console(t, b, stages, ir_len)
    c = np.array(coeffs, np.float32)
    p = tops.num_partitions(ir_len, b)
    h_t = tops.partition_spectra(torch.from_numpy(ir), b)
    h_j = jops.partition_spectra(jnp.asarray(ir), b)
    core = jsession.make_session_core("xla", stages)
    zeq = np.zeros((stages, t, 2), np.float32)
    zf = np.zeros((2, p, b + 1), np.float32)
    st = [torch.from_numpy(a.copy()) for a in
          (zeq, np.zeros((2, b), np.float32), zf, zf)]
    sj = [jnp.asarray(a) for a in (zeq, np.zeros((2, b), np.float32), zf, zf)]
    for i in range(p + 3):
        x = rng.uniform(-1, 1, (t, b)).astype(np.float32)
        mix_t, *st = tsession.session_block(
            torch.from_numpy(x), torch.from_numpy(c), st[0],
            torch.from_numpy(send), torch.from_numpy(pan2), *st[1:], *h_t)
        mix_j, *sj = core(jnp.asarray(x), jnp.asarray(c), sj[0],
                          jnp.asarray(send), jnp.asarray(pan2), *sj[1:], *h_j)
        _close(mix_t, mix_j, f"mix at block {i}")
        for name, o, r in zip(("eq", "bus", "fdl_re", "fdl_im"), st, sj):
            _close(o, r, f"{name} at block {i}")


def _cfgs(**over):
    base = dict(n_tracks=8, buffer_size=64, ir_length=300, n_runs=2,
                warmup=1, device_timing=False)
    base.update(over)
    return (BenchConfig(**base),
            JaxConfig(write_latencies=False, quiet=True, **base))


def _port(**over):
    cfg, _ = _cfgs(**over)
    b = tsession.DAWSessionMixBenchmark(cfg, CPU)
    b.setup()
    return b


@pytest.mark.parametrize("stages", [1, 4, 16])
def test_benchmark_runs_on_from_the_reference_mid_stream(stages):
    """The JAX benchmark runs 6 blocks; the port takes its (eq, prev, fre,
    fim), H and block count, and both run 3 more: the mixes agree and the
    port validates against the golden."""
    cfg, jcfg = _cfgs(session_eq_stages=stages)
    ref = jsession.DAWSessionMixBenchmark(jcfg)
    ref.setup()
    for _ in range(5):
        ref.iterate()
    ours = tsession.DAWSessionMixBenchmark(cfg, CPU)
    ours.setup()
    ours.load_state([np.asarray(a) for a in
                     (ref._eq, ref._prev, ref._fre, ref._fim)],
                    ref._invocations, h=[np.asarray(a) for a in ref._h])
    for i in range(3):
        ref.iterate()
        ours.iterate()
        _close(ours.host_output, ref.host_output, f"mix {i}")
    v = ours.validate()
    assert v.passed, v.messages
    assert v.max_error < 1e-5


def test_load_state_rejects_wrong_shapes():
    b = _port()
    with pytest.raises(ValueError, match="state shapes"):
        b.load_state([np.zeros((3, 8, 2), np.float32)] * 4, 1)


@pytest.mark.parametrize("verification", ["full", "spot"])
def test_benchmark_validates_through_the_runner(verification):
    cfg, _ = _cfgs(n_runs=3, pipeline_depth=8, saturated_reps=2,
                   overlap_depth=4, overlap_reps=1, device_timing=True,
                   verification=verification)
    b = tsession.DAWSessionMixBenchmark(cfg, CPU)
    b.setup()
    r = run_benchmark(b, cfg, verbose=False)
    assert r.validation.passed, r.validation.messages
    assert r.metadata["impl"] == "torch-plain"
    assert r.overlap_statistics is not None
    assert b.host_output.shape == (2, 64)


def test_metadata_and_cost_model_match_the_reference():
    cfg, jcfg = _cfgs(session_eq_stages=6)
    ours = tsession.DAWSessionMixBenchmark(cfg, CPU)
    ours.setup()
    ref = jsession.DAWSessionMixBenchmark(jcfg)
    ref.setup()
    md, ref_md = ours.metadata(), ref.metadata()
    # impl names the route: the plain twin here, the XLA path there.
    assert (md.pop("impl"), ref_md.pop("impl")) == ("torch-plain", "xla")
    assert md == ref_md
    assert ours.cost_model() == ref.cost_model()
    assert ours.transfer_model() == ref.transfer_model()
    assert ours.bytes_processed() == ref.bytes_processed()
    assert ours.memory_report() == ref.memory_report()


def test_streaming_matches_iterate():
    """stream_body's carry after n steps equals the benchmark's state
    after n blocks (its set-up's and n - 1 iterates), bit for bit."""
    a, b = _port(), _port()
    step, carry = a.stream_body()
    for _ in range(3):
        carry, _ = step(carry)
    for _ in range(2):
        b.iterate()
    for o, r in zip(carry[1], (b._eq, b._prev, b._fre, b._fim)):
        assert torch.equal(o, r)


def test_device_iterate_leaves_the_timing_state_unchanged():
    b = _port()
    before = [t.clone() for t in b._timing]
    for _ in range(3):
        b.device_iterate()
    for now, then in zip(b._timing, before):
        assert torch.equal(now, then)


def test_eq_runs_the_cascade_wrapper(monkeypatch):
    """Every block runs the EQ through ``ops.iir.iir_cascade`` (the
    systolic kernel on the card, its plain twin here) once."""
    calls = []
    real = tsession.iir_cascade

    def counted(*args):
        calls.append(args[1].shape)
        return real(*args)

    monkeypatch.setattr(tsession, "iir_cascade", counted)
    b = _port(session_eq_stages=5)
    b.iterate()
    b.device_iterate()
    assert calls == [(5, 5)] * 3
    assert tsession.iir_cascade is not iir_ops.iir_cascade_plain


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    tsession.check_full_fp32()


def test_setup_refuses_tf32_matmuls():
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            _port()
    finally:
        torch.set_float32_matmul_precision(old)
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("stages", [0, 17])
def test_config_bounds_like_the_reference(stages):
    with pytest.raises(ValueError, match="session_eq_stages"):
        BenchConfig(session_eq_stages=stages).validate()
    with pytest.raises(ValueError, match="session_eq_stages"):
        JaxConfig(session_eq_stages=stages).validate()
    assert cli.main(["--benchmark", "DAWSessionMix", "--sessionEqStages",
                     str(stages)], device="cpu") == 1
