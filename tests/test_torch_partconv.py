"""The PyTorch port's PartConv (``ops/partconv.py``, ``models/partconv.py``)
against the JAX package's, on the CPU at toy size, from seeded NumPy
inputs.

Tolerances: a block's output and every state leaf within 1e-5 of that
leaf's peak of the JAX one (two FFT libraries round differently; the
block algebra is the same); the fold-algebra golden within 1e-6 (both
are NumPy float64); the IR bank bit for bit; the benchmark's own
validation at its 1e-3 contract.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpuaudiobench_tpu.config import BenchConfig as JaxConfig
from gpuaudiobench_tpu.models import partconv as jmodel
from gpuaudiobench_tpu.ops import partconv as jops
from gpuaudiobench_tpu.utils import data as jdata
from gpuaudiobench_tpu_torch import cli
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
from gpuaudiobench_tpu_torch.harness.streaming import run_chained
from gpuaudiobench_tpu_torch.models import partconv as tmodel
from gpuaudiobench_tpu_torch.ops import partconv as tops
from gpuaudiobench_tpu_torch.utils import data as tdata

CPU = torch.device("cpu")
REL = 1e-5


def _close(ours, ref, what, rel=REL):
    """``ours`` (a tensor, array or int) within rel of ``ref``'s peak."""
    if isinstance(ours, int):
        assert ours == int(ref), what
        return
    o = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    r = np.asarray(ref, np.float64)
    assert o.shape == r.shape, (what, o.shape, r.shape)
    peak = max(float(np.abs(r).max()), 1e-12)
    err = float(np.abs(o.astype(np.float64) - r).max())
    assert err <= rel * peak, f"{what}: {err:.3g} > {rel:g} x {peak:.3g}"


def _ir(t, length, seed=5):
    return np.random.default_rng(seed).standard_normal(
        (t, length)).astype(np.float32)


def _blocks(n, t, b, seed=9):
    g = np.random.default_rng(seed)
    return [g.standard_normal((t, b)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("length", [300, 1000])
def test_partition_spectra_match(length):
    ir = _ir(4, length)
    ours = tops.partition_spectra(torch.from_numpy(ir), 64)
    ref = jops.partition_spectra(jnp.asarray(ir), 64)
    for o, r, w in zip(ours, ref, ("re", "im")):
        _close(o, r, w)


@pytest.mark.parametrize("length", [300, 1000])
@pytest.mark.parametrize("form", ["shift", "ring"])
def test_uniform_block_matches_the_reference(form, length):
    t, b = 4, 64
    ir = _ir(t, length)
    p = tops.num_partitions(length, b)
    h_t = tops.partition_spectra(torch.from_numpy(ir), b)
    h_j = jops.partition_spectra(jnp.asarray(ir), b)
    if form == "ring":
        h_t = tops.ring_aligned_spectra(*h_t)
        h_j = jops.ring_aligned_spectra(*h_j)
    z = np.zeros((t, p, b + 1), np.float32)
    st = (torch.zeros(t, b), p - 1, torch.from_numpy(z.copy()),
          torch.from_numpy(z.copy()))
    sj = (jnp.zeros((t, b)), jnp.int32(p - 1), jnp.asarray(z), jnp.asarray(z))
    for i, x in enumerate(_blocks(p + 3, t, b)):
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
        if form == "shift":
            yt, a, c = tops.partconv_block(xt, st[0], st[2], st[3], *h_t)
            st = (xt, st[1], a, c)
            yj, a, c = jops.partconv_block(xj, sj[0], sj[2], sj[3], *h_j)
            sj = (xj, sj[1], a, c)
        else:
            yt, hd, a, c = tops.partconv_block_ring(xt, *st, *h_t)
            st = (xt, hd, a, c)
            yj, hd, a, c = jops.partconv_block_ring(xj, *sj, *h_j)
            sj = (xj, hd, a, c)
        _close(yt, yj, f"y at block {i}")
        for k, (o, r) in enumerate(zip(st, sj)):
            _close(o, r, f"leaf {k} at block {i}")


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("length", [300, 1000])
def test_nupols_block_matches_the_reference_leaf_for_leaf(length, k):
    t, b = 4, 64
    ir = _ir(t, length)
    m = tops.nupols_tail_partitions(length, b, k)
    assert m == jops.nupols_tail_partitions(length, b, k) > 0
    assert tops.nupols_group_len(m, k) == jops.nupols_group_len(m, k)
    (hh_t, ht_t) = tops.nupols_spectra(torch.from_numpy(ir), b, k)
    (hh_j, ht_j) = jops.nupols_spectra(jnp.asarray(ir), b, k)
    for o, r in zip(hh_t + ht_t, hh_j + ht_j):
        _close(o, r, "nupols spectra")
    st = tops.state_to_device(tops.nupols_init_state(t, b, k, m), CPU)
    sj = tuple(jnp.asarray(a) for a in jops.nupols_init_state(t, b, k, m))
    for a, r in zip(st, jops.nupols_init_state(t, b, k, m)):
        _close(a, r, "initial state")
    block_t = tops.make_partconv_block_nupols(b, k, m)
    block_j = jops.make_partconv_block_nupols(b, k, m)
    p = tops.num_partitions(length, b)
    for i, x in enumerate(_blocks(p + 3, t, b)):
        yt, st = block_t(torch.from_numpy(x), st, *hh_t, *ht_t)
        yj, sj = block_j(jnp.asarray(x), sj, *hh_j, *ht_j)
        _close(yt, yj, f"y at block {i}")
        for leaf, (o, r) in enumerate(zip(st, sj)):
            _close(o, r, f"leaf {leaf} at block {i}")


@pytest.mark.parametrize("k", [1, 2, 3, 5, 9, 40])
@pytest.mark.parametrize("length", [64, 300, 1000])
def test_fold_golden_equals_the_reference(length, k):
    x = _blocks(1, 3, 64, seed=k)[0]
    ir = _ir(3, length, seed=length)
    ours = tmodel.partconv_reference(x, ir, k, 64)
    ref = jmodel.partconv_reference(x, ir, k, 64)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,seed", [((2, 300), 42), ((5, 1000), 7),
                                        ((1, 1), 3), ((3, 48000), 42)])
def test_reverb_impulse_responses_bit_for_bit(shape, seed):
    ours = tdata.reverb_impulse_responses(*shape, seed)
    ref = jdata.reverb_impulse_responses(*shape, seed)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def _cfgs(**over):
    base = dict(n_tracks=4, buffer_size=64, ir_length=1000, n_runs=2,
                warmup=1, device_timing=False)
    base.update(over)
    port = BenchConfig(**base)
    ref = JaxConfig(write_latencies=False, quiet=True, **base)
    return port, ref


def _port(**over):
    cfg, _ = _cfgs(**over)
    b = tmodel.PartConvBenchmark(cfg, CPU)
    b.setup()
    return b


FORMS = {"shift": {}, "ring": {"partconv_form": "ring"},
         "nupols": {"partconv_form": "nupols", "partconv_tail_chunk": 4},
         "shift f16": {"partconv_h_dtype": "f16"},
         "ring f16": {"partconv_form": "ring", "partconv_h_dtype": "f16"},
         "nupols f16": {"partconv_form": "nupols", "partconv_tail_chunk": 2,
                        "partconv_h_dtype": "f16"}}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_load_state_runs_on_from_the_reference_mid_stream(form):
    """The JAX benchmark runs 5 blocks; the port takes its state, H and
    block count and both run 4 more: the outputs agree block by block and
    the port validates."""
    cfg, jcfg = _cfgs(**FORMS[form])
    ref = jmodel.PartConvBenchmark(jcfg)
    ref.setup()
    for _ in range(4):
        ref.iterate()
    ours = tmodel.PartConvBenchmark(cfg, CPU)
    ours.setup()
    state = tuple(np.asarray(a) for a in ref._state)
    ours.load_state(state, ref._invocations,
                    h=[np.asarray(a) for a in ref._h])
    for i in range(4):
        ref.iterate()
        ours.iterate()
        _close(ours.host_output, ref.host_output, f"{form} block {i}")
    assert ours._invocations == ref._invocations == 9
    v = ours.validate()
    assert v.passed, v.messages
    if "f16" in form:
        assert all(h.dtype == torch.float16 for h in ours._h)
        assert v.max_error < 1e-3
    else:
        assert v.max_error < 1e-5


def test_load_state_rejects_a_state_of_another_form():
    b = _port(partconv_form="nupols", partconv_tail_chunk=4)
    with pytest.raises(ValueError, match="14 leaves"):
        b.load_state((np.zeros((4, 64), np.float32), 0, None, None), 1)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_benchmark_validates_through_the_runner(form):
    cfg, _ = _cfgs(pipeline_depth=9, saturated_reps=2, overlap_depth=4,
                   overlap_reps=1, device_timing=True, **FORMS[form])
    b = tmodel.PartConvBenchmark(cfg, CPU)
    b.setup()
    r = run_benchmark(b, cfg, verbose=False)
    assert r.validation.passed, r.validation.messages
    md = r.metadata
    assert md["formResolved"] == FORMS[form].get("partconv_form", "shift")
    assert md["hDtype"] == FORMS[form].get("partconv_h_dtype", "f32")
    assert r.saturated_statistics is not None
    assert r.overlap_statistics is not None


@pytest.mark.parametrize("form", sorted(FORMS))
def test_metadata_and_cost_model_match_the_reference(form):
    cfg, jcfg = _cfgs(**FORMS[form])
    ours = tmodel.PartConvBenchmark(cfg, CPU)
    ours.setup()
    ref = jmodel.PartConvBenchmark(jcfg)
    ref.setup()
    assert ours.metadata() == ref.metadata()
    assert ours.cost_model() == ref.cost_model()
    assert ours.transfer_model() == ref.transfer_model()
    assert ours.memory_report() == ref.memory_report()


@pytest.mark.parametrize("form", ["shift", "ring", "nupols"])
def test_device_iterate_leaves_the_timing_state_unchanged(form):
    b = _port(**FORMS[form])
    before = tops.clone_state(b._timing_state)
    for _ in range(3):
        b.device_iterate()
    for leaf, (now, then) in enumerate(zip(b._timing_state, before)):
        if isinstance(then, int):
            assert now == then
        else:
            assert torch.equal(now, then), leaf


@pytest.mark.parametrize("form", ["shift", "ring", "nupols"])
def test_iterate_after_a_stream_and_an_overlap_pass_matches_one_without(form):
    """The stream and the overlap pass own their states: iterate's output
    after them equals a run that had neither, bit for bit."""
    a, b = _port(**FORMS[form]), _port(**FORMS[form])
    step, carry = a.stream_body()
    run_chained(step, carry, 5)
    f, blocks, c = a.overlap_body()
    for j in range(3):
        _, c = f(torch.from_numpy(blocks[j % 2]), c)
    for _ in range(3):
        a.iterate()
        b.iterate()
        np.testing.assert_array_equal(a.host_output, b.host_output)


def test_overlap_block_copies_its_input():
    """The block carries its input as the next ``prev``; the overlap tier
    refills an input slot while the next block may still read it, so the
    overlap step takes a copy."""
    b = _port()
    f, blocks, carry = b.overlap_body()
    x = torch.from_numpy(blocks[0].copy())
    _, carry = f(x, carry)
    assert carry[0] is not x and torch.equal(carry[0], x)


def test_ring_block_writes_one_slot_in_place():
    t, b, p = 2, 8, 3
    h = tops.ring_aligned_spectra(*tops.partition_spectra(
        torch.from_numpy(_ir(t, 20)), b))
    fre, fim = torch.zeros(t, p, b + 1), torch.zeros(t, p, b + 1)
    x = torch.ones(t, b)
    _, head, fre2, fim2 = tops.partconv_block_ring(
        x, torch.zeros(t, b), p - 1, fre, fim, *h)
    assert head == 0 and fre2 is fre and fim2 is fim
    assert fre[:, 0].abs().sum() > 0 and fre[:, 1:].abs().sum() == 0


def test_nupols_headonly_falls_back_to_shift():
    b = _port(n_tracks=2, buffer_size=32, ir_length=128,
              partconv_form="nupols", partconv_tail_chunk=8)
    assert b.metadata()["formResolved"] == "shift"
    assert b.metadata()["form"] == "nupols"
    assert b.nupols_tail == 0
    for _ in range(3):
        b.iterate()
    v = b.validate()
    assert v.passed, v.messages


def test_nupols_state_leaves_are_the_references():
    for t, b, k, m in ((3, 8, 4, 4), (1, 64, 8, 11)):
        ours = tops.nupols_init_state(t, b, k, m)
        ref = jops.nupols_init_state(t, b, k, m)
        assert len(ours) == len(ref) == 14
        for o, r in zip(ours, ref):
            assert np.shape(o) == np.shape(r)
            assert np.array_equal(np.asarray(o), np.asarray(r))


@pytest.mark.parametrize("knobs,needle", [
    ({"partconv_tail_chunk": 1}, "partconv_tail_chunk"),
    ({"partconv_tail_chunk": 65}, "partconv_tail_chunk"),
    ({"partconv_form": "gardner"}, "partconv form"),
    ({"partconv_h_dtype": "bf16"}, "partconv H dtype"),
])
def test_config_rejects_like_the_reference(knobs, needle):
    with pytest.raises(ValueError, match=needle):
        BenchConfig(**knobs).validate()
    with pytest.raises(ValueError, match=needle):
        JaxConfig(**knobs).validate()


@pytest.mark.parametrize("argv", [["--partconvForm", "gardner"],
                                  ["--partconvTailChunk", "1"],
                                  ["--partconvHDtype", "bf16"]])
def test_cli_rejects_a_bad_partconv_flag(argv, capsys):
    assert cli.main(["--benchmark", "PartConv"] + argv, device="cpu") == 1
    assert "Error:" in capsys.readouterr().out
