"""The port's soak (``gpuaudiobench_tpu_torch/tools/soak.py``) against the
reference's ``tools/soak.py``, on the CPU at toy sizes.

* ``stream_state_rms`` equals the reference's on the same numpy-seeded
  carries within 1e-6 relative (float32 sums in another order).
* N seconds of ModalFilterBank equal the reference's ``one_second`` scan
  carried N times (the JAX package's XLA body, whose carry holds the
  phasors unscaled: the port's are its amplitude times them), within
  1e-5 of the peak, with re-excitation every second and with renorm.
  The two formulations round each rotation apart, so the states drift
  apart with the sample count (2.2e-5 of the peak after 18,432 samples
  at 1,024 modes): the toy second is 12 blocks of 64 samples, 2,304
  samples in 3 seconds.
  The reference's ``reexcite`` is a closure inside its ``main``, so the
  test carries a copy of its three lines.
* A soak of 3 s ends on the carry of 1 s, a checkpoint and 2 s resumed,
  bit for bit, through the tool's ``main``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuaudiobench_tpu.config import BenchConfig as JaxConfig
from gpuaudiobench_tpu.models.modal import ModalFilterBankBenchmark as JaxModal
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness import checkpoint as ck
from gpuaudiobench_tpu_torch.registry import create_benchmark
from gpuaudiobench_tpu_torch.tools import soak

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from soak import stream_state_rms as ref_state_rms  # noqa: E402

CPU = torch.device("cpu")
RMS_RTOL = 1e-6
SOAK_RTOL = 1e-5  # of the peak
# 12 blocks of 64 samples a second at fs 768: a toy second.
TOY = dict(n_tracks=1, fs=768, buffer_size=64, modal_num_modes=1024,
           n_runs=1, warmup=1, write_latencies=False, device_timing=False,
           verification="none")


def _carries(rng, case):
    """(carry, entry carry) pairs as numpy arrays: the reference test's
    shapes and a random mix with an int leaf and a bfloat16 leaf."""
    f32 = np.float32
    if case == "constant-excluded":
        x0 = rng.uniform(-1, 1, (128, 512)).astype(f32)
        z1 = (0.01 * rng.uniform(-1, 1, (128, 2))).astype(f32)
        return (x0, z1), (x0, np.zeros((128, 2), f32))
    if case == "unevolved":
        x0 = np.linspace(-1, 1, 256, dtype=f32).reshape(2, 128)
        return (x0,), (x0,)
    if case == "integers":
        ph0 = np.arange(8, dtype=np.int32)
        return (ph0 + 512, np.full(4, 0.25, f32)), (ph0, np.zeros(4, f32))
    if case == "all-int":
        ph0 = np.arange(8, dtype=np.int32)
        return (ph0 + 1,), (ph0,)
    if case == "small-drift":
        pool = np.full((4096, 128), 0.5, f32)
        z0 = np.full((128,), 1.0, f32)
        return (pool, (z0 * f32(1.01)).astype(f32)), (pool, z0)
    if case == "mixed":
        a0 = rng.standard_normal((64, 33)).astype(f32)
        b0 = rng.standard_normal(100).astype(f32)
        c0 = rng.standard_normal((7, 9)).astype(f32)
        a1 = a0 + rng.standard_normal((64, 33)).astype(f32)
        c1 = (3 * c0).astype(f32)
        return ((a1, (b0, np.int64(3)), c1), (a0, (b0, np.int64(0)), c0))
    raise KeyError(case)


CASES = ["constant-excluded", "unevolved", "integers", "all-int",
         "small-drift", "mixed"]


def _torch_tree(c):
    if isinstance(c, tuple):
        return tuple(_torch_tree(x) for x in c)
    return torch.from_numpy(np.array(c))


@pytest.mark.parametrize("case", CASES)
def test_state_rms_is_the_reference(rng, case):
    c, c0 = _carries(rng, case)
    want = float(ref_state_rms(c, c0))
    got = soak.stream_state_rms(_torch_tree(c), _torch_tree(c0))
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=RMS_RTOL, abs=0)


def test_state_rms_squares_bfloat16_leaves_as_the_reference(rng):
    a0 = rng.standard_normal((16, 8)).astype(np.float32)
    a1 = (a0 * 1.5).astype(np.float32)
    jc, jc0 = (jnp.asarray(a1, jnp.bfloat16),), (jnp.asarray(a0, jnp.bfloat16),)
    want = float(ref_state_rms(jc, jc0))
    got = soak.stream_state_rms(
        (torch.from_numpy(a1).to(torch.bfloat16),),
        (torch.from_numpy(a0).to(torch.bfloat16),))
    assert float(got) == pytest.approx(want, rel=RMS_RTOL, abs=0)


def test_reexcite_touches_only_moved_float_leaves():
    entry = (torch.ones(3), torch.full((2,), 2.0), torch.arange(4), 7)
    c = (torch.ones(3), torch.full((2,), 4.0), torch.arange(4) + 1, 9)
    soak.reexcite(c, entry)
    assert c[0].tolist() == [1.0] * 3  # unchanged: a carried constant
    assert c[1].tolist() == [5.0, 5.0]  # 4 + 0.5 * 2
    assert c[2].tolist() == [1, 2, 3, 4] and c[3] == 9


def _jax_reexcite(c, c0):
    """The reference's ``reexcite`` (``tools/soak.py``, a closure inside
    its ``main``), line for line."""
    def mix(a, b):
        a_ = jnp.asarray(a)
        if not jnp.issubdtype(a_.dtype, jnp.floating):
            return a
        if bool(jnp.array_equal(a_, jnp.asarray(b))):
            return a
        return (a_ + 0.5 * jnp.asarray(b)).astype(a_.dtype)

    return jax.tree.map(mix, c, c0)


def _jax_soak(cfg, seconds, reexcite_every):
    """The reference's soak loop over its ``one_second`` scan: the
    per-second probe RMS and the final carry."""
    jb = JaxModal(cfg)
    jb.setup()
    step_fn, carry = jb.stream_body()
    blocks = -(-cfg.fs // cfg.buffer_size)

    @jax.jit
    def one_second(c):
        def f(c, _):
            c2, probe = step_fn(c)
            return c2, probe
        return jax.lax.scan(f, c, None, length=blocks)

    carry0, rms = carry, []
    for sec in range(seconds):
        if reexcite_every and sec and sec % reexcite_every == 0:
            carry = _jax_reexcite(carry, carry0)
        carry, probes = one_second(carry)
        p = np.asarray(probes).astype(np.float64)
        rms.append(float(np.sqrt(np.mean(p ** 2))))
    return jb, rms, carry


@pytest.mark.parametrize("reexcite_every,renorm", [(0, False), (1, False),
                                                   (0, True)])
def test_modal_soak_is_the_reference_scan(reexcite_every, renorm):
    seconds = 3
    jcfg = JaxConfig(impl="xla", modal_renorm=renorm, **TOY)
    jb, jrms, jcarry = _jax_soak(jcfg, seconds, reexcite_every)
    pcfg = BenchConfig(modal_renorm=renorm, **TOY)
    pb = create_benchmark("ModalFilterBank", pcfg, CPU)
    pb.setup()
    res = soak.run_soak(pb, seconds, reexcite_every=reexcite_every,
                        log=lambda s: None)
    assert res["form"] == "loop" and res["blocks"] == 12
    assert [r[0] for r in res["rows"]] == list(range(seconds))
    np.testing.assert_allclose([r[3] for r in res["rows"]], jrms,
                               rtol=SOAK_RTOL)
    # The port carries amp * (re, im); the reference's XLA body (re, im).
    amp = np.asarray(jcarry[0])
    _, _, re, im = res["carry"]
    for got, want in ((re, jcarry[3]), (im, jcarry[4])):
        want = amp * np.asarray(want)
        peak = np.abs(want).max()
        assert peak > 0
        assert np.abs(got.numpy() - want).max() <= SOAK_RTOL * peak
    assert all(np.isfinite(r[4]) and r[4] > 0 for r in res["rows"])


def test_reexcitation_changes_the_soak():
    pcfg = BenchConfig(**TOY)
    runs = []
    for every in (0, 1):
        pb = create_benchmark("ModalFilterBank", pcfg, CPU)
        pb.setup()
        runs.append(soak.run_soak(pb, 2, reexcite_every=every,
                                  log=lambda s: None))
    assert runs[1]["rows"][0][3:] == runs[0]["rows"][0][3:]
    assert runs[1]["rows"][1][4] != runs[0]["rows"][1][4]
    assert not torch.equal(runs[1]["carry"][2], runs[0]["carry"][2])


def _leaves_equal(a, b):
    with np.load(a) as za, np.load(b) as zb:
        keys = [k for k in za.files if k.startswith("leaf_")]
        return keys == [k for k in zb.files if k.startswith("leaf_")] and \
            all(np.array_equal(za[k], zb[k]) for k in keys)


def test_resume_continues_bit_for_bit(tmp_path):
    md = str(tmp_path / "soak.md")
    base = ["ModalFilterBank", "1", "--set", "modal_num_modes=1024",
            "--set", "fs=6000", "--device", "cpu"]
    straight, split = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    assert soak.main(["3", md] + base + ["--checkpoint", straight]) == 0
    assert soak.main(["1", md] + base + ["--checkpoint", split]) == 0
    assert soak.main(["2", md] + base + ["--checkpoint", split,
                                         "--resume"]) == 0
    assert _leaves_equal(straight, split)
    assert ck.read_header(straight)["extra"] == {"soak_seconds": 3,
                                                 "tracks": 1}
    text = open(md).read()
    assert "| chain form | loop |" in text
    csv = open(str(tmp_path / "soak.csv")).read().splitlines()
    assert csv[0] == "second,wall_ms,ms_per_block,probe_rms,state_rms"
    assert len(csv) == 3


def test_report_keeps_the_reference_rows(tmp_path):
    md = str(tmp_path / "r.md")
    assert soak.main(["2", md, "DWG1DNaive", "4", "--set",
                      "dwg_max_length=120", "--set", "fs=6000",
                      "--device", "cpu"]) == 0
    text = open(md).read()
    for row in ("seconds of audio", "mean ms/block",
                "p50 / p95 / max ms/block (per-second averages)",
                "seconds over the 85.333 ms/block deadline",
                "drift, median of first 1 s -> last 1 s",
                "probe RMS first / last (output liveness)",
                "state RMS first / last (carry integrity)",
                "state RMS min / max over the soak", "chain form",
                "entry copy of the carry (state RMS, re-excitation)",
                "peak device memory"):
        assert f"| {row} |" in text, row
    assert text.startswith("# Sustained-load soak (cpu): DWG1DNaive (4 "
                           "tracks), continuous")
    assert "Probe RMS 0 is STRUCTURAL for DWG" in text


@pytest.mark.parametrize("argv", [
    ["1", "x.md", "--resume"],
    ["1", "x.md", "--checkpoint"],
    ["1", "x.md", "ModalFilterBank", "8", "2", "--renorm"],
    ["1", "x.md", "datacopy5050", "8"],
])
def test_main_refuses_bad_arguments(tmp_path, argv):
    argv = [str(tmp_path / a) if a.endswith(".md") else a for a in argv]
    assert soak.main(argv + ["--device", "cpu"]) == 1


def test_main_runs_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        soak.main(["1", os.devnull, "gain", "8"])
