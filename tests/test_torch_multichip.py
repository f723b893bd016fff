"""The port's MultiChipSuite and ICIBandwidth
(``gpuaudiobench_tpu_torch/parallel/multichip.py``,
``models/multichip_bench.py``) against the JAX package's, on gloo ranks
and the conftest's 8-device CPU mesh, at toy size.

Tolerances: one suite step within 1e-5 of the peak of JAX's
``make_suite_step`` on the same mesh (the sums of the psum, the FIR and
the bank fold may run in another order), and within the benchmark's
1e-4 of ``suite_reference``. The collectives one step issues are held to
the JAX package's inventory (``parallel/ici_model.py:suite_collectives``)
by kind and bytes. Every spawn has a hard timeout.
"""

import jax
import numpy as np
import pytest
import torch

from gpuaudiobench_tpu.models.multichip_bench import build_mesh as jbuild
from gpuaudiobench_tpu.models.multichip_bench import (
    suite_reference as jax_suite_reference,
)
from gpuaudiobench_tpu.parallel.ici_model import suite_collectives
from gpuaudiobench_tpu.parallel.multichip import (
    make_suite_step as jax_make_suite_step,
)
from gpuaudiobench_tpu.parallel.multichip import (
    suite_step_example_args as jax_example_args,
)
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.models import multichip_bench as tbench
from gpuaudiobench_tpu_torch.parallel import collectives as col
from gpuaudiobench_tpu_torch.parallel import multichip as tmulti
from gpuaudiobench_tpu_torch.parallel import ranks
from gpuaudiobench_tpu_torch.parallel.launch import spmd
from gpuaudiobench_tpu_torch.parallel.mesh import AXES
from gpuaudiobench_tpu_torch.registry import create_benchmark

CPU = torch.device("cpu")
SPAWN_TIMEOUT_S = 180
# (tracks, samples, modes, ir_len) of the step tests; the inventory
# meshes take tests/test_multichip.py's (16, 256, 32*tp*8, 33).
TOY = (16, 64, 128, 9)
STEP_MESHES = {8: [(2, 2, 2), (8, 1, 1), (1, 1, 8)],
               4: [(1, 2, 2), (1, 4, 1)],
               2: [(1, 1, 2)]}


def _sizes(shape):
    if shape in STEP_MESHES[4] or shape == (1, 1, 2):
        return 16, 256, 32 * shape[1] * 8, 33
    return TOY


@pytest.fixture(scope="module")
def steps():
    """{mesh: (output whole, collectives issued)} of one port step on each
    mesh: one spawn a world size; 1 x 1 x 1 in this process."""
    out = {}
    for world, shapes in STEP_MESHES.items():
        res = spmd(ranks.suite_check, world, "cpu",
                   [(s, _sizes(s)) for s in shapes], 42, "cpu",
                   timeout_s=SPAWN_TIMEOUT_S)
        out.update(zip(shapes, res))
    out[(1, 1, 1)] = ranks.suite_check([((1, 1, 1), TOY)], device="cpu")[0]
    return out


def _jax_args(shape):
    mesh = jbuild(shape, AXES)
    return mesh, jax_example_args(mesh, *_sizes(shape), seed=42)


def _jax_step(shape):
    mesh, args = _jax_args(shape)
    y = np.asarray(jax.block_until_ready(
        jax_make_suite_step(mesh)(*args)))
    return y, [np.asarray(a) for a in args]


ALL_MESHES = [(1, 1, 1)] + [s for v in STEP_MESHES.values() for s in v]


@pytest.mark.parametrize("shape", ALL_MESHES)
def test_suite_step_matches_jax_and_the_golden(steps, shape):
    ours, _ = steps[shape]
    ref, args = _jax_step(shape)
    assert ours.shape == ref.shape and ours.dtype == np.float32
    peak = float(np.abs(ref).max())
    assert np.abs(ours - ref).max() <= 1e-5 * peak
    golden = tbench.suite_reference(*args, n_stages=shape[1])
    np.testing.assert_array_equal(
        golden, jax_suite_reference(*args, n_stages=shape[1]))
    assert np.abs(ours - golden).max() <= 1e-4 * float(np.abs(golden).max())


@pytest.mark.parametrize("shape", ALL_MESHES)
def test_example_args_are_the_references(shape):
    tracks, samples, modes, ir_len = _sizes(shape)
    ours = tmulti.suite_step_example_args(shape, tracks, samples, modes,
                                          ir_len, 42)
    theirs = _jax_args(shape)[1]
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, np.asarray(b))


def _by_kind(records):
    out = {}
    for r in records:
        k = out.setdefault(r["kind"], [0, 0])
        k[0] += 1
        k[1] += r["bytes"]
    return out


@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 1, 2)])
def test_step_collectives_equal_the_references_inventory(steps, shape):
    """Calls and bytes by kind as suite_collectives counts them; at
    (1, 2, 2) that is the compiled HLO's 2 all-gathers, 2 all-reduces
    and 3 collective-permutes (1 halo, n_micro * (tp - 1) = 2 handoffs;
    tests/test_multichip.py:392-394)."""
    _, records = steps[shape]
    dp, tp, sp = shape
    inv = suite_collectives(16 // dp, 256, sp=sp, tp=tp, ir_len=33)
    want = {}
    for c in inv:
        k = want.setdefault(c["kind"], [0, 0])
        k[1] += c["bytes"]
        if "pp handoffs" in c["label"]:
            k[0] += 2 * (tp - 1)  # one call a microbatch a hop
        else:
            k[0] += 1
    assert _by_kind(records) == want
    if shape == (1, 2, 2):
        assert {k: v[0] for k, v in want.items()} == {
            "all_gather": 2, "psum": 2, "ppermute": 3}


def test_pipeline_issues_only_the_live_handoffs(steps):
    """At (1, 4, 1) the GPipe loop's handoffs after all but its last step:
    n_micro + tp - 2 = 4 ppermutes of one microbatch each."""
    _, records = steps[(1, 4, 1)]
    hand = [r for r in records if r["kind"] == "ppermute"]
    assert len(hand) == 2 + 4 - 2
    assert all(r["bytes"] == (16 // 2) * 256 * 4 and r["axis_n"] == 4
               for r in hand)


def test_one_rank_step_issues_no_collective(steps):
    assert steps[(1, 1, 1)][1] == []


def _cfg(**kw):
    return BenchConfig(buffer_size=64, n_tracks=8, n_runs=1, warmup=0,
                       write_latencies=False, device_timing=False,
                       transfer_mib=1).replace(**kw)


@pytest.mark.parametrize("name,kw,needle", [
    ("MultiChipSuite", {"modal_num_modes": 1000}, "divisible by 32"),
    ("MultiChipSuite", {"mesh": "1,1,8", "buffer_size": 16},
     "smaller than the FIR length"),
    ("MultiChipSuite", {"mesh": "2,2"}, "expects 'dp,tp,sp'"),
    ("ICIBandwidth", {"mesh": "2,0,1"}, "expects 'dp,tp,sp'"),
    ("MultiChipSuite", {"data_parallel": 2}, "not --dataParallel"),
    ("ICIBandwidth", {"data_parallel": 2}, "does not apply"),
])
def test_setup_refusals_keep_the_references_messages(name, kw, needle):
    from gpuaudiobench_tpu.config import BenchConfig as JaxConfig
    from gpuaudiobench_tpu.registry import create_benchmark as jax_create

    ours = create_benchmark(name, _cfg(**kw), CPU)
    with pytest.raises(ValueError, match=needle) as e:
        ours.setup()
    theirs = jax_create(name, JaxConfig(**{
        **dict(buffer_size=64, n_tracks=8, n_runs=1, warmup=0,
               write_latencies=False, device_timing=False, transfer_mib=1),
        **kw}))
    with pytest.raises(ValueError) as je:
        theirs.setup()
    assert str(e.value) == str(je.value)


def test_the_fir_refuses_tf32_convolutions(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        tmulti.check_fp32_convolutions("MultiChipSuite")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    tmulti.check_fp32_convolutions("MultiChipSuite")


def test_one_rank_benchmark_matches_the_reference_cost_and_metadata():
    from gpuaudiobench_tpu.config import BenchConfig as JaxConfig
    from gpuaudiobench_tpu.registry import create_benchmark as jax_create

    for name in ("MultiChipSuite", "ICIBandwidth"):
        ours = create_benchmark(name, _cfg(), CPU)
        ours.setup()
        assert ours.validate().passed
        theirs = jax_create(name, JaxConfig(
            buffer_size=64, n_tracks=8, n_runs=1, warmup=0,
            write_latencies=False, device_timing=False, transfer_mib=1))
        theirs.setup()
        assert ours.cost_model() == theirs.cost_model()
        assert ours.total_elements() == theirs.total_elements()
        assert ours.bytes_processed() == theirs.bytes_processed()
        md = dict(ours.metadata())
        assert md.pop("collectiveInventory") == []
        assert md == theirs.metadata()
        assert ours.memory_report() == theirs.memory_report()
    assert col.COLLECTIVES == [] or all(
        c["axis_n"] > 1 for c in col.COLLECTIVES)
