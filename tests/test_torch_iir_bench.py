"""The IIR slice of the PyTorch port (IIRFilter in both forms and
BiquadChain) against the JAX package, end to end on the CPU at 8 tracks
x 512 samples, and the port's copies of the reference's host pieces.

Both packages generate the same seeded input and coefficients; the port
runs its plain twins on the CPU and the JAX package its XLA forms.
Tolerances, absolute: outputs and states 1e-6 for the scan (the same f32
recurrence), 1e-5 for the blockstate form and the 10-stage cascade (the
reference's bars for those forms, ``tests/test_pallas_ops.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpuaudiobench_tpu import config as jax_config
from gpuaudiobench_tpu.harness import validation as jax_validation
from gpuaudiobench_tpu.models.iir import iir_reference as jax_iir_reference
from gpuaudiobench_tpu.registry import create_benchmark as jax_create
from gpuaudiobench_tpu.utils import data as jax_data
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness import validation as tvalidation
from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
from gpuaudiobench_tpu_torch.models.common import expand_rows
from gpuaudiobench_tpu_torch.models.iir import iir_reference
from gpuaudiobench_tpu_torch.registry import create_benchmark
from gpuaudiobench_tpu_torch.utils import data as tdata

CPU = torch.device("cpu")
SCAN_ATOL = 1e-6
FORM_ATOL = 1e-5

# (benchmark, config knobs, tolerance, name of the state attribute)
CASES = {
    "scan": ("IIRFilter", {}, SCAN_ATOL, "host_state"),
    "blockstate": ("IIRFilter", {"iir_form": "blockstate", "iir_block_m": 16},
                   FORM_ATOL, "host_state"),
    "chain": ("BiquadChain", {}, FORM_ATOL, "host_states"),
}


@pytest.fixture
def jax_cfg(small_cfg):
    return small_cfg.replace(buffer_size=512, impl="xla")


def _port(cfg):
    """The reference's config as the port's, knob for knob."""
    return BenchConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(BenchConfig)})


def _pair(jax_cfg, case):
    name, knobs, tol, state_attr = CASES[case]
    cfg = jax_cfg.replace(**knobs)
    jb = jax_create(name, cfg)
    jb.setup()
    pb = create_benchmark(name, _port(cfg), CPU)
    pb.setup()
    return jb, pb, tol, state_attr


@pytest.mark.parametrize("case", sorted(CASES))
def test_slice_matches_jax(jax_cfg, case):
    jb, pb, tol, state_attr = _pair(jax_cfg, case)
    assert np.array_equal(pb.host_input, jb.host_input)
    np.testing.assert_allclose(pb.host_output, np.asarray(jb.host_output),
                               atol=tol, rtol=0)
    np.testing.assert_allclose(getattr(pb, state_attr),
                               np.asarray(getattr(jb, state_attr)),
                               atol=tol, rtol=0)
    v = pb.validate()
    assert v.passed, v.messages[:3]
    assert jb.validate().passed
    assert pb.metadata()["impl"] == "torch-plain"


@pytest.mark.parametrize("case", sorted(CASES))
def test_slice_runs_through_the_runner(jax_cfg, case):
    name, knobs, _, _ = CASES[case]
    cfg = _port(jax_cfg.replace(**knobs)).replace(
        n_runs=2, warmup=1, pipeline_depth=4, saturated_reps=2,
        device_timing=True)
    b = create_benchmark(name, cfg, CPU)
    b.setup()
    res = run_benchmark(b, cfg, verbose=False)
    assert res.validation.passed, res.validation.messages[:3]
    assert len(res.latencies) == 2 and len(res.saturated_latencies) == 2
    assert res.device_timing_method == "wall"  # the CPU's label
    assert res.device_statistics.count == 2
    mem = res.metadata["memory"]
    assert mem["totalBytes"] == sum(v for k, v in mem.items()
                                    if k != "totalBytes")


@pytest.mark.parametrize("case", ["scan", "blockstate"])
def test_repeated_iterations_stay_valid(jax_cfg, case):
    """The state carries across iterations; the golden replays one block
    per performed iteration, so validation holds for any count."""
    jb, pb, tol, _ = _pair(jax_cfg, case)
    for _ in range(4):
        pb.iterate()
        jb.iterate()
    assert pb._invocations == jb._invocations == 5
    v = pb.validate()
    assert v.passed, v.messages[:3]
    np.testing.assert_allclose(pb.host_state, np.asarray(jb.host_state),
                               atol=tol, rtol=0)
    assert jb.validate().passed
    assert np.array_equal(pb.golden, jb.golden)  # the same replay


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("what", ["output", "state"])
def test_corrupted_result_fails_validation(jax_cfg, case, what):
    _, pb, _, state_attr = _pair(jax_cfg, case)
    attr = "host_output" if what == "output" else state_attr
    bad = getattr(pb, attr).copy()
    bad.reshape(-1)[3] += 0.01
    setattr(pb, attr, bad)
    v = pb.validate()
    assert not v.passed
    assert any(what in m for m in v.messages)


def test_iir_load_state_resumes_a_jax_run(jax_cfg):
    """The port picks up a JAX IIRFilter mid-stream: its next block
    matches the JAX benchmark's next block."""
    jb = jax_create("IIRFilter", jax_cfg)
    jb.setup()
    for _ in range(3):
        jb.iterate()
    pb = create_benchmark("IIRFilter", _port(jax_cfg), CPU)
    pb.load_state(jb.host_input, np.array(jb.coeffs, np.float32),
                  np.asarray(jb.host_state))
    jb.iterate()
    np.testing.assert_allclose(pb.host_output, np.asarray(jb.host_output),
                               atol=SCAN_ATOL, rtol=0)
    np.testing.assert_allclose(pb.host_state, np.asarray(jb.host_state),
                               atol=SCAN_ATOL, rtol=0)
    assert pb.validate().passed


def test_chain_load_state_resumes_a_jax_stream(jax_cfg):
    """BiquadChain from the cascade states a JAX stream carried after two
    blocks: the port's round trip is the JAX stream's third block."""
    jb = jax_create("BiquadChain", jax_cfg)
    jb.setup()
    coeffs = np.array(jb.stage_coeffs, np.float32)
    states = np.zeros((10, jax_cfg.n_tracks, 2), np.float32)
    for _ in range(2):
        _, states = jb._step_pair(jb.host_input, coeffs, states)
    y3, states3 = jb._step_pair(jb.host_input, coeffs, states)
    pb = create_benchmark("BiquadChain", _port(jax_cfg), CPU)
    pb.load_state(jb.host_input, coeffs, np.asarray(states))
    np.testing.assert_allclose(pb.host_output, np.asarray(y3),
                               atol=FORM_ATOL, rtol=0)
    np.testing.assert_allclose(pb.host_states, np.asarray(states3),
                               atol=FORM_ATOL, rtol=0)
    assert pb.validate().passed


def test_load_state_rejects_wrong_shapes(jax_cfg):
    pb = create_benchmark("IIRFilter", _port(jax_cfg), CPU)
    pb.setup()
    with pytest.raises(ValueError, match="state"):
        pb.load_state(pb.host_input, np.zeros(5, np.float32),
                      np.zeros((3, 2), np.float32))
    with pytest.raises(ValueError, match="float32"):
        pb.load_state(pb.host_input[:, :64].copy(), np.zeros(5, np.float32),
                      np.zeros((8, 2), np.float32))
    cb = create_benchmark("BiquadChain", _port(jax_cfg), CPU)
    with pytest.raises(ValueError, match="coeffs"):
        cb.load_state(pb.host_input, np.zeros((9, 5), np.float32),
                      np.zeros((10, 8, 2), np.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_spot_check_replays_only_the_tracks_it_reads(jax_cfg, case):
    """Under spot verification the golden covers exactly the tracks the
    spot indices reach, and validation still catches a wrong sample
    there."""
    name, knobs, _, state_attr = CASES[case]
    cfg = _port(jax_cfg.replace(n_tracks=64, verification="spot",
                                spot_sample_limit=20, **knobs))
    b = create_benchmark(name, cfg, CPU)
    b.setup()
    assert b.validate().passed
    rows = b.checked_tracks(getattr(b, state_attr).shape)
    assert 0 < len(rows) < 64 and np.all(np.diff(rows) > 0)
    golden = b.golden
    assert np.isnan(golden).any(axis=1).sum() == 64 - len(rows)
    assert np.isfinite(golden[rows]).all()
    idx = tvalidation.spot_indices(b.host_output.size, 20)[1]
    bad = b.host_output.copy()
    bad.reshape(-1)[idx] += 0.01
    b.host_output = bad
    assert not b.validate().passed


def test_checked_tracks_is_none_unless_spot(jax_cfg):
    for mode in ("full", "none"):
        b = create_benchmark("IIRFilter",
                             _port(jax_cfg.replace(verification=mode)), CPU)
        assert b.checked_tracks((8, 2)) is None


def test_expand_rows():
    part = np.arange(6, dtype=np.float32).reshape(2, 3)
    full = expand_rows(part, np.array([0, 2]), (3, 3))
    assert np.array_equal(full[[0, 2]], part) and np.isnan(full[1]).all()
    assert expand_rows(part, None, (2, 3)) is part
    states = expand_rows(np.ones((2, 1, 2), np.float32), np.array([1]),
                         (2, 3, 2), axis=1)
    assert np.isnan(states[:, [0, 2]]).all() and (states[:, 1] == 1).all()


def test_verification_none_skips_the_golden(jax_cfg):
    b = create_benchmark("IIRFilter",
                         _port(jax_cfg.replace(verification="none")), CPU)
    b.setup()
    v = b.validate()
    assert v.status.value == "SKIPPED" and v.passed


# -- the port's copies of the reference's host pieces --------------------

@pytest.mark.parametrize("n,seed", [(1, 42), (4096, 42), (1000, 7)])
def test_generate_random_audio_is_the_reference(n, seed):
    ours = tdata.generate_random_audio(n, seed)
    theirs = jax_data.generate_random_audio(n, seed)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


@pytest.mark.parametrize("fc,q", [(0.25, 0.707), (0.1375, 0.707),
                                  (0.4, 2.0)])
def test_biquad_lowpass_coefficients_are_the_reference(fc, q):
    ours = tdata.biquad_lowpass_coefficients(fc, q)
    theirs = jax_data.biquad_lowpass_coefficients(fc, q)
    assert [type(v) for v in ours] == [type(v) for v in theirs]
    assert ours == theirs


def test_iir_reference_is_the_reference_golden(rng):
    x = (rng.random((6, 40), dtype=np.float32) * 2 - 1).astype(np.float32)
    z = (rng.random((6, 2), dtype=np.float32) - 0.5).astype(np.float32)
    c = jax_data.biquad_lowpass_coefficients(0.2)
    for a, b in zip(iir_reference(x, c, z), jax_iir_reference(x, c, z)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("mode,limit,scale", [
    ("full", 1024, 1.0), ("full", 1024, 1.001), ("spot", 50, 1.001),
    ("none", 1024, 2.0)])
def test_compare_abs_matches_the_reference(rng, mode, limit, scale):
    ref = (rng.random((8, 130)) * 2 - 1).astype(np.float32)
    out = (ref * np.float32(scale)).astype(np.float32)
    kw = dict(mode=mode, limit=limit, label="iir")
    ours = tvalidation.compare_abs(out, ref, 1e-4, **kw)
    theirs = jax_validation.compare_abs(out, ref, 1e-4, **kw)
    assert ours.status.value == theirs.status.value
    for k in ("max_error", "mean_error", "error_count", "samples_checked",
              "messages"):
        assert getattr(ours, k) == getattr(theirs, k), k
    bad = tvalidation.compare_abs(out[:, :5], ref, 1e-4, mode=mode)
    assert bad.status.value == jax_validation.compare_abs(
        out[:, :5], ref, 1e-4, mode=mode).status.value


def test_merge_failure_matches_the_reference(rng):
    ref = (rng.random(64) * 2 - 1).astype(np.float32)
    out = ref.copy()
    out[3] += 1.0
    merged = []
    for mod in (tvalidation, jax_validation):
        v = mod.compare_abs(ref, ref, 1e-4, label="a")
        v.merge_failure(mod.compare_abs(out, ref, 1e-4, label="b"))
        v.merge_failure(mod.compare_abs(out, ref, 1e-4, mode="none"))
        merged.append(v)
    ours, theirs = merged
    assert ours.status.value == theirs.status.value == "FAILURE"
    for k in ("max_error", "error_count", "samples_checked", "messages"):
        assert getattr(ours, k) == getattr(theirs, k), k


def test_config_fields_of_the_slice_match_the_reference():
    ref = {f.name: f for f in dataclasses.fields(jax_config.BenchConfig)}
    for name in ("fs", "iir_form", "iir_block_m", "json_output", "quiet",
                 "output_file", "device_timing"):
        ours = next(f for f in dataclasses.fields(BenchConfig)
                    if f.name == name)
        assert ours.default == ref[name].default, name
    assert BenchConfig().deadline_ms() == jax_config.BenchConfig(
    ).deadline_ms()


@pytest.mark.parametrize("knobs", [
    {"iir_form": "fir"}, {"iir_block_m": 1}, {"iir_block_m": 129},
    {"iir_form": "blockstate", "buffer_size": 509}, {"fs": 0},
    {"n_runs": 0}, {"buffer_size": 0}, {"verification": "some"},
    {"impl": "triton"},
    {"iir_form": "blockstate", "buffer_size": 100, "iir_block_m": 16},
    {"iir_form": "scan", "buffer_size": 509},
    {"fdtd_room": 7}, {"fdtd_room": 129}, {"fdtd_room": 8},
    {"dwg_min_length": 3}, {"dwg_min_length": 300, "dwg_max_length": 200},
    {"dwg_min_length": 4, "dwg_max_length": 4},
])
def test_config_validate_raises_the_reference_errors(knobs):
    try:
        jax_config.BenchConfig(**knobs).validate()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            BenchConfig(**knobs).validate()
        assert str(got.value) == str(e)
    else:
        BenchConfig(**knobs).validate()
