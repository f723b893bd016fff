"""The references and the frozen copies against the port's plain twins at
small sizes on the CPU. The tests import both; the references do not."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rtbench import harness, spec, stats
from rtbench.tests.conftest import BENCH, first_cell, small_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_inputs_repeat_for_a_seed_and_differ_between_seeds(config):
    cell = small_cell(first_cell(config))
    ref = cell.reference()
    big = 2 ** 31 + 12345
    a = ref.make_inputs(cell.config, big, CPU)
    b = ref.make_inputs(cell.config, big, CPU)
    c = ref.make_inputs(cell.config, big + 1, CPU)
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert not torch.equal(a[k], c[k]), k


def test_checked_blocks_repeat_and_hold_the_last():
    assert harness.checked_blocks(1000, 16, 5) == harness.checked_blocks(1000, 16, 5)
    assert harness.checked_blocks(1000, 16, 5) != harness.checked_blocks(1000, 16, 6)
    assert harness.checked_blocks(1000, 16, 5)[-1] == 999
    assert harness.checked_blocks(3, 16, 5) == [0, 1, 2]


def _modal_inputs(cell, seed=3):
    ref = cell.reference()
    return ref, ref.make_inputs(cell.config, seed, CPU)


def test_modal_stream_reference_follows_the_plain_folded_step():
    from gpuaudiobench_tpu_torch.ops.modal import modal_folded_step_plain

    cell = small_cell("modal_1m.stream")
    conf = dict(cell.config, buffer_size=64)
    ref, t = _modal_inputs(cell)
    re, im = t["amp"] * t["state_re"], t["amp"] * t["state_im"]
    probes = []
    for _ in range(3):
        out, re, im = modal_folded_step_plain(t["cos_w"], t["sin_w"], re, im,
                                              64, conf["output_tracks"])
        probes.append(float(out.abs().mean()))
    check = cell.check()
    got = {"state": check.program_state((None, None, re, im)),
           "probes": dict(enumerate(probes)), "blocks": 3,
           "checked": [0, 1, 2]}
    numbers = check.judge(t, conf, got, CPU)["numbers"]
    assert numbers["state_rms"] < 1e-5
    assert numbers["probe_err"] < 1e-5


def test_modal_callback_reference_follows_the_plain_bank():
    from gpuaudiobench_tpu_torch.ops.modal import modal_bank_plain

    cell = small_cell("modal_1m.callback")
    conf = dict(cell.config, buffer_size=64)
    _, t = _modal_inputs(cell, seed=11)
    out, _, _ = modal_bank_plain(t["amp"], t["cos_w"], t["sin_w"],
                                 t["state_re"], t["state_im"], 64,
                                 conf["output_tracks"])
    check = cell.check()
    assert check.output(t, conf, CPU).shape == tuple(out.shape)
    numbers = check.judge(t, conf, {"outputs": [out.numpy()]}, CPU)["numbers"]
    assert numbers["out_err"] < 1e-5


def test_modal_closed_form_matches_stepping_in_float64():
    cell = small_cell("modal_1m.stream")
    conf = dict(cell.config, buffer_size=8)
    ref, t = _modal_inputs(cell, seed=9)
    x = {k: v.numpy() for k, v in t.items()}
    # Block 5's first sample is the stream's 41st: the closed form at 40
    # samples, then one step.
    stepped = ref.block_output(t, conf, 5, CPU)
    c, s = x["cos_w"].astype(np.float64), x["sin_w"].astype(np.float64)
    z = x["amp"].astype(np.float64) * (x["state_re"] + 1j * x["state_im"].astype(np.float64))
    for _ in range(41):
        z = z * (c + 1j * s)
    first = z.real.reshape(-1, conf["output_tracks"]).sum(axis=0)
    np.testing.assert_allclose(stepped[0], first, rtol=1e-10, atol=1e-10)


def test_rndmem_reference_follows_the_programs_step():
    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.models.rndmem import RndMemBenchmark

    cell = small_cell("rndmem_65536.stream")
    conf = cell.config
    ref = cell.reference()
    t = ref.make_inputs(conf, 21, CPU)
    x = {k: v.numpy() for k, v in t.items()}
    bench = RndMemBenchmark(BenchConfig(**conf["program"]["bench_config"]), CPU)
    bench.load_state(x["pool"], x["starts"], x["ends"], x["starts"])
    step, ph = bench.stream_body()
    # The loader ran block 0; the stream begins at block 1.
    for b in range(1, 200):
        assert torch.equal(ph.to(torch.int64), ref.playheads(t, conf, b, CPU)), b
        ph, p = step(ph)
        assert float(p[0]) == ref.block_probe(t["pool"], t, conf, b, CPU)


def test_cost_copies_match_the_programs_cost_models():
    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.models.modal import ModalFilterBankBenchmark
    from gpuaudiobench_tpu_torch.models.rndmem import RndMemBenchmark

    bench = spec.load_benchmark()
    confs = {c["name"]: spec.load_json(spec.ROOT / c["file"]) for c in bench["configs"]}
    modal, rnd = confs["modal_1m"], confs["rndmem_65536"]
    prog = ModalFilterBankBenchmark(
        BenchConfig(**modal["program"]["bench_config"]), CPU).cost_model()
    mine = spec.load_module("cost", "modal_bank").cost(modal)
    assert mine["bytes"] == prog["hbm_bytes"]
    # The program counts the unfolded form's amp multiply, which the
    # stream's folded step does not make.
    assert mine["flops"] == prog["flops"] - modal["modes"] * modal["buffer_size"]
    prog = RndMemBenchmark(
        BenchConfig(**rnd["program"]["bench_config"]), CPU).cost_model()
    mine = spec.load_module("cost", "rndmem_gather").cost(rnd)
    assert (mine["flops"], mine["bytes"]) == (prog["flops"], prog["hbm_bytes"])


def test_frozen_percentile_and_busy_union_match_the_programs():
    from gpuaudiobench_tpu_torch.harness.profiler import summarize
    from gpuaudiobench_tpu_torch.harness.statistics import (
        interpolated_percentile)

    rng = np.random.default_rng(0)
    vals = sorted(rng.random(1001).tolist())
    for p in (0, 12.5, 50, 95, 99, 100):
        assert stats.interpolated_percentile(vals, p) == interpolated_percentile(vals, p)
    events = []
    for i in range(200):
        a = float(rng.random() * 1000)
        events.append((f"k{i % 3}", a, a + float(rng.random() * 20)))
    busy = sum(b - a for a, b in stats.merged((a, b) for _, a, b in events))
    assert busy == pytest.approx(summarize(events, 1)["device_busy_us_per_block"],
                                 rel=1e-12)
