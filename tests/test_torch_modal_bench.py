"""The ModalFilterBank slice of the PyTorch port against the JAX package,
end to end on the CPU at toy size (8 tracks -> 8192 modes, 64-sample
blocks).

Both benchmarks compute on identical mode tables: the JAX benchmark's
``bench.params`` are loaded into the port with ``load_params``. Output
tolerance: 1e-5 of the peak (f32 sums in another order); probes 1e-5
relative.
"""

import dataclasses
import importlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from gpuaudiobench_tpu.models.modal import (
    ModalFilterBankBenchmark as JaxModal,
    modal_reference as jax_modal_reference,
)
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.models.modal import (
    ModalFilterBankBenchmark,
    modal_reference,
    params_from_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
OUT_RTOL = 1e-5
N_BLOCKS = 4


@pytest.fixture
def xla_cfg(small_cfg):
    return small_cfg.replace(impl="xla")


def _port(cfg):
    """The reference's config as the port's, knob for knob."""
    return BenchConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(BenchConfig)})


def test_modal_reference_is_the_reference_golden(rng):
    m, t_out, s = 1024, 32, 48
    amp = rng.random(m, dtype=np.float32)
    w = 2 * np.pi * rng.random(m, dtype=np.float32) * 0.45
    cw, sw = np.cos(w).astype(np.float32), np.sin(w).astype(np.float32)
    re = (rng.random(m, dtype=np.float32) * 2 - 1).astype(np.float32)
    im = (rng.random(m, dtype=np.float32) * 2 - 1).astype(np.float32)
    ours = modal_reference(amp, cw, sw, re, im, s, t_out)
    ref = jax_modal_reference(amp, cw, sw, re, im, s, t_out)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


def test_setup_generates_the_reference_tables(xla_cfg):
    jb = JaxModal(xla_cfg)
    jb.setup()
    pb = ModalFilterBankBenchmark(_port(xla_cfg), CPU)
    pb.setup()
    assert pb.padded_modes == jb.padded_modes
    for k, v in jb.params.items():
        assert np.array_equal(pb.params[k], v), k
    assert np.array_equal(pb.golden, jb.golden)


def _chain(step, carry, n, to_numpy):
    probes = []
    for _ in range(n):
        carry, p = step(carry)
        probes.append(to_numpy(p))
    return np.concatenate(probes)


@pytest.mark.parametrize("renorm", [False, True])
def test_slice_matches_jax(xla_cfg, renorm):
    cfg = xla_cfg.replace(modal_renorm=renorm)
    jb = JaxModal(cfg)
    jb.setup()
    pb = ModalFilterBankBenchmark(_port(cfg), CPU)
    pb.load_params(jb.params)

    ref = np.asarray(jb.host_output)
    assert pb.host_output.shape == ref.shape
    peak = np.abs(ref).max()
    assert np.abs(pb.host_output - ref).max() <= OUT_RTOL * peak
    assert pb.validate().passed
    assert pb.metadata()["impl"] == "torch-plain"

    jstep, jcarry = jb.stream_body()
    pstep, pcarry = pb.stream_body()
    jp = _chain(jstep, jcarry, N_BLOCKS, np.asarray)
    pp = _chain(pstep, pcarry, N_BLOCKS, lambda t: t.numpy())
    assert pp.shape == jp.shape == (N_BLOCKS,)
    np.testing.assert_allclose(pp, jp, rtol=OUT_RTOL)


def test_load_params_rejects_wrong_mode_count(xla_cfg):
    jb = JaxModal(xla_cfg.replace(n_tracks=4))
    jb.setup()
    pb = ModalFilterBankBenchmark(_port(xla_cfg), CPU)
    with pytest.raises(ValueError, match="modes"):
        pb.load_params(jb.params)


def test_params_from_numpy_places_float32_tensors():
    params = {k: np.arange(64, dtype=np.float32) for k in
              ("amp", "cos_w", "sin_w", "state_re", "state_im")}
    out = params_from_numpy(params, CPU)
    assert set(out) == set(params)
    for k, t in out.items():
        assert t.dtype == torch.float32 and t.device == CPU
        assert np.array_equal(t.numpy(), params[k])
    params["amp"] = params["amp"].astype(np.float64)
    with pytest.raises(ValueError, match="float32"):
        params_from_numpy(params, CPU)


def test_validate_catches_a_wrong_output(xla_cfg):
    pb = ModalFilterBankBenchmark(_port(xla_cfg), CPU)
    pb.setup()
    assert pb.validate().passed
    pb.host_output = pb.host_output * np.float32(1.01)
    assert not pb.validate().passed


def _run_main(main, **kw):
    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        rc = main(**kw)
    finally:
        sys.stdout = old
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


def test_bench_main_json_has_every_root_key():
    from gpuaudiobench_tpu_torch import bench as tbench

    sys.path.insert(0, REPO)
    try:
        root_bench = importlib.import_module("bench")
    finally:
        sys.path.pop(0)
    toy = dict(n_tracks=8, n_runs=3, warmup=1, pipeline_depth=4)
    rc_root, root = _run_main(root_bench.main, **toy)
    rc, rec = _run_main(tbench.main, device="cpu", **toy)
    assert rc_root == 0 and rc == 0
    assert set(root) <= set(rec), set(root) - set(rec)
    assert rec["metric"] == "modal_1M_block_ms"
    assert rec["validation"] == "passed"
    for key in ("value", "vs_baseline", "blocks_per_sec_per_chip",
                "saturated_rep_p50_ms", "saturated_rep_min_ms",
                "roundtrip_p50_ms", "roundtrip_p99_ms"):
        assert isinstance(rec[key], (int, float)) and rec[key] > 0, key
    assert rec["value"] == rec["saturated_rep_p50_ms"]
    assert rec["saturated_rep_min_ms"] <= rec["saturated_rep_p50_ms"]
    assert rec["backend"] == "torch-cpu" and rec["device_name"] == "cpu"
    assert rec["power_limit"] is None
    assert rec["kernel_launches"] == 0  # the CPU runs the plain twin
    assert rec["chain_form"] == "loop"  # no CUDA graph on the CPU
    assert 0 <= rec["validation_max_error"] <= 1e-4
