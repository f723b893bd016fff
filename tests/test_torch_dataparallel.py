"""``--dataParallel 8``: the port's 21 sharded benchmarks on a gloo mesh of
8 ranks against the JAX package at ``data_parallel=8`` on the conftest's
8 virtual CPU devices, and against the port's own one-rank run.

Every case runs at the toy size of ``tests/test_multichip.py:79-155``
(buffer 64, 16 tracks, 2 runs, 1 warmup) through the runner, all of them
in ONE launch of 8 ranks (``parallel/ranks.py:dp_runs``), with the
device tier and a saturated tier of depth 4, so every rank goes through
every tier in lock step. Checked for each case:

* it validates against its golden on 8 ranks;
* its host output equals the JAX package's at the benchmark's own
  tolerance (``TOLERANCE``), after as many round trips (the runner's
  set-up, warmup and timed ones: 4). Conv1D's bleed mode with L - 1 > S
  is held to the golden only: the JAX package's XLA bleed pads one track
  and misses it (ROADMAP.md §3);
* its host output equals the port's one-rank output bit for bit where a
  rank's arithmetic is per track, within 1e-6 of the peak where a psum
  reorders a sum (ModalFilterBank, DWG, DAWSessionMix), and within 1e-6
  of the peak on the FFT paths (FFT1D, Conv1D_accel);
* it really is sharded: each rank's resident shard holds 1/8 of the axis
  (the modal bank's, 1/8 of the padded modes plus its fold padding);
* ``metadata.collectiveInventory`` lists the collectives a round trip
  issued: one psum of the (T_out, S), (S,) and (3, B) bus tensors for
  ModalFilterBank, DWG and DAWSessionMix, one all_gather for the
  datacopy family and Conv1D's bleed halo, one pmax of a float a layer
  for int8 NeuralAmp (its activation scale), none for the rest.

NeuralAmp in int8 (C = 12, padded to 16, and C = 16) is held to its own
tolerance against the JAX package, and bit for bit to the one-rank run;
a further test runs it on 2 and 4 ranks too, against the JAX package's
max error at the same data_parallel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from gpuaudiobench_tpu.config import BenchConfig as JaxConfig
from gpuaudiobench_tpu.registry import create_benchmark as jax_create
from gpuaudiobench_tpu_torch.parallel import ranks
from gpuaudiobench_tpu_torch.parallel.launch import spmd

SPAWN_TIMEOUT_S = 300
RANKS = 8

TOY = dict(buffer_size=64, n_tracks=16, n_runs=2, warmup=1,
           write_latencies=False, pipeline_depth=4, saturated_reps=2)
# (id, name, config fields): the 21 names the JAX package shards, two
# IIR forms and three Conv1D windows (bleed at L = 33 <= S and at the
# default L = 1,024, whose 16-track halo spans several ranks), and
# NeuralAmp in int8 at C = 12 and 16. The datacopy pools are the smallest
# whose portions 2, 4 and 8 ranks divide.
CASES = [(n, n, dict(TOY)) for n in (
    "NoOp", "gain", "GainStats", "IIRFilter", "BiquadChain", "FFT1D",
    "Conv1D", "Conv1D_accel", "ModalFilterBank", "DWG1DNaive",
    "DWG1DAccel")] + [
    ("IIRFilter-blockstate", "IIRFilter", dict(TOY, iir_form="blockstate")),
    ("Conv1D-bleed-33", "Conv1D", dict(TOY, conv_edge_mode="bleed",
                                       ir_length=33)),
    ("Conv1D-bleed-1024", "Conv1D", dict(TOY, conv_edge_mode="bleed")),
    ("RndMemRead", "RndMemRead", dict(TOY, rndmem_pool_mb=8)),
    ("PartConv", "PartConv", dict(TOY, ir_length=256)),
    ("NeuralAmp", "NeuralAmp", dict(TOY, neuralamp_channels=16,
                                    neuralamp_layers=4)),
    ("NeuralAmp-int8-C12", "NeuralAmp", dict(
        TOY, neuralamp_dtype="int8", neuralamp_channels=12,
        neuralamp_layers=4)),
    ("NeuralAmp-int8-C16", "NeuralAmp", dict(
        TOY, neuralamp_dtype="int8", neuralamp_channels=16,
        neuralamp_layers=4)),
    ("NeuralAmpLSTM", "NeuralAmpLSTM", dict(TOY, neuralamp_channels=16)),
    ("DAWSessionMix", "DAWSessionMix", dict(TOY, ir_length=256)),
    ("datacopy5050", "datacopy5050", dict(TOY, transfer_mib=1)),
    ("datacopy2080", "datacopy2080", dict(TOY, transfer_mib=10)),
    ("datacopy8020", "datacopy8020", dict(TOY, transfer_mib=10)),
    ("datacopy0199", "datacopy0199", dict(TOY, transfer_mib=25)),
    ("datacopy9901", "datacopy9901", dict(TOY, transfer_mib=25)),
]
IDS = [c[0] for c in CASES]

# Each benchmark's own tolerance (its validate()): absolute, or relative
# to the peak of the reference array ("rel").
TOLERANCE = {
    "NoOp": (1e-5, "abs"), "gain": (1e-5, "abs"),
    "GainStats": (1e-5, "abs"), "IIRFilter": (1e-4, "abs"),
    "BiquadChain": (1e-4, "abs"), "FFT1D": (1e-3, "abs"),
    "Conv1D": (1e-3, "abs"), "Conv1D_accel": (1e-3, "rel"),
    "ModalFilterBank": (1e-4, "rel"), "DWG1DNaive": (1e-2, "abs"),
    "DWG1DAccel": (1e-2, "abs"), "RndMemRead": (1e-6, "abs"),
    "PartConv": (1e-3, "rel"), "NeuralAmp": (1e-4, "rel"),
    "NeuralAmpLSTM": (1e-4, "rel"), "DAWSessionMix": (1e-3, "rel"),
}
# NeuralAmp's tolerance in int8 (models/neuralamp.py:TOLERANCE): one
# rounding step of an int8 activation moves an output by ~1e-4 of the peak.
INT8_TOLERANCE = (5e-2, "rel")
# The state arrays' own tolerances, where a benchmark validates them.
STATE_TOLERANCE = {"host_stats": 1e-4, "host_state": 1e-3,
                   "host_states": 1e-3}
# Where a psum reorders a sum over the ranks: N ranks within this share
# of the one-rank output's peak; everything else is bit for bit.
PSUM_NAMES = {"ModalFilterBank", "DWG1DNaive", "DWG1DAccel",
              "DAWSessionMix"}
PSUM_RTOL = 1e-6
# The FFT paths (a batched FFT over fewer rows): within this share of
# the peak.
FFT_NAMES = {"FFT1D", "Conv1D_accel"}
FFT_RTOL = 1e-6
# The round trips a run makes: set-up, warmup and timed.
ROUND_TRIPS = 1 + TOY["warmup"] + TOY["n_runs"]
SKIP_HOST = ("host_input", "host_pool")


def tolerance(name: str, fields: dict = None):
    if (fields or {}).get("neuralamp_dtype") == "int8":
        return INT8_TOLERANCE
    return TOLERANCE.get(name, (1e-5, "abs"))  # datacopy*: 1e-5


def outputs(host: dict) -> dict:
    return {k: v for k, v in host.items() if k not in SKIP_HOST}


def within(got, want, tol, kind) -> float:
    """max |got - want| over the allowed error (<= 1 passes)."""
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    scale = float(np.max(np.abs(want))) if kind == "rel" else 1.0
    return err / (tol * scale)


def jax_host(name: str, fields: dict, ranks: int = RANKS) -> dict:
    """The JAX benchmark's host arrays at data_parallel=``ranks`` after
    ``ROUND_TRIPS`` round trips (its set-up makes the first)."""
    known = {f.name for f in dataclasses.fields(JaxConfig)}
    cfg = JaxConfig(**{k: v for k, v in fields.items() if k in known},
                    data_parallel=ranks, device_timing=False)
    b = jax_create(name, cfg)
    b.setup()
    for _ in range(ROUND_TRIPS - 1):
        b.iterate()
    assert b._sharding is not None
    v = b.validate()
    host = {k: np.asarray(v_) for k, v_ in vars(b).items()
            if k.startswith("host_") and isinstance(v_, np.ndarray)}
    return {"passed": v.passed, "max_error": v.max_error, "host": host}


@pytest.fixture(scope="module")
def runs():
    """{id: (one-rank run, 8-rank run)}: the one-rank runs in this
    process, the 8-rank ones in one launch."""
    cases = [(name, fields) for _, name, fields in CASES]
    one = ranks.dp_runs(cases, device="cpu")
    many = spmd(ranks.dp_runs, RANKS, "cpu", cases, "cpu",
                timeout_s=SPAWN_TIMEOUT_S)
    return dict(zip(IDS, zip(one, many)))


@pytest.fixture(scope="module")
def jax_runs():
    return {cid: jax_host(name, fields) for cid, name, fields in CASES}


def _case(cid):
    return next(c for c in CASES if c[0] == cid)


@pytest.mark.parametrize("cid", IDS)
def test_validates_on_8_ranks(runs, cid):
    one, many = runs[cid]
    for run in (one, many):
        assert not isinstance(run, str), run
        rec = run[0]
        assert rec["validation"]["status"] == "SUCCESS", rec["validation"]
    rec = many[0]
    # More than one rank: the saturated chain is a loop.
    if rec["metadata"].get("chainForm") is not None:
        assert rec["metadata"]["chainForm"] == "loop"
    assert one[0]["metadata"].get("collectiveInventory") is None


@pytest.mark.parametrize("cid", IDS)
def test_matches_the_jax_package_at_dp8(runs, jax_runs, cid):
    _, name, fields = _case(cid)
    ours = outputs(runs[cid][1][1])
    theirs = jax_runs[cid]
    if (fields.get("conv_edge_mode") == "bleed"
            and fields.get("ir_length", 1024) - 1 > fields["buffer_size"]):
        # The reference's one-track bleed misses its own golden here; the
        # port meets it (test_validates_on_8_ranks).
        assert not theirs["passed"]
        return
    assert theirs["passed"]
    shared = set(ours) & set(theirs["host"])
    assert {"host_output", "host_re"} & shared, sorted(ours)
    tol, kind = tolerance(name, fields)
    for k in sorted(shared):
        want = theirs["host"][k]
        assert ours[k].shape == want.shape, k
        if name == "FFT1D":  # |d_re| + |d_im| <= tol
            continue
        t = STATE_TOLERANCE.get(k, tol)
        assert within(ours[k], want, t, kind) <= 1.0, k
    if name == "FFT1D":
        err = (np.abs(ours["host_re"] - theirs["host"]["host_re"])
               + np.abs(ours["host_im"] - theirs["host"]["host_im"]))
        assert float(err.max()) <= tol


@pytest.mark.parametrize("cid", IDS)
def test_equals_the_one_rank_run(runs, cid):
    _, name, _ = _case(cid)
    one, many = (outputs(r[1]) for r in runs[cid])
    assert sorted(one) == sorted(many)
    for k in one:
        assert one[k].shape == many[k].shape, k
        if name in PSUM_NAMES or name in FFT_NAMES:
            rtol = PSUM_RTOL if name in PSUM_NAMES else FFT_RTOL
            peak = float(np.max(np.abs(one[k]))) or 1.0
            assert float(np.max(np.abs(one[k] - many[k]))) <= rtol * peak, k
        else:
            assert np.array_equal(one[k], many[k]), k


@pytest.mark.parametrize("cid", IDS)
def test_each_rank_holds_its_shard(runs, cid):
    """The counterpart of ``bench._sharding is not None``: every rank's
    resident shard holds 1/8 of the sharded axis."""
    _, name, fields = _case(cid)
    shapes = runs[cid][1][2]
    assert len(shapes) == RANKS
    t = fields["n_tracks"]
    for r, s in enumerate(shapes):
        if name == "ModalFilterBank":
            modes = min(1024 * t, 1024 * 1024) // RANKS
            t_out = min(t, 32)
            head = (r * modes) % t_out
            assert s["_dev.amp"] == (head + modes + (-(head + modes) % t_out),)
        elif name.startswith("DWG"):
            assert s["_consts.0"] == (t // RANKS,)
            assert s["_resident_input"] == (fields["buffer_size"],)
        elif name == "RndMemRead":
            assert s["_ph_dev"] == (t // RANKS,)
        elif name.startswith("datacopy"):
            floats = fields["transfer_mib"] * 1024 * 1024 // 4
            rin = int(name[8:10]) / 100
            assert s["_resident_input"] == (int(floats * rin) // RANKS,)
        else:
            assert s["_resident_input"][0] == t // RANKS


@pytest.mark.parametrize("cid", IDS)
def test_collective_inventory_lists_a_round_trips_collectives(runs, cid):
    _, name, fields = _case(cid)
    inv = [(c["kind"], c["axis"], c["axis_n"], c["bytes"])
           for c in runs[cid][1][0]["metadata"]["collectiveInventory"]]
    s, t = fields["buffer_size"], fields["n_tracks"]
    if name == "ModalFilterBank":
        want = [("psum", "dp", RANKS, min(t, 32) * s * 4)]
    elif name.startswith("DWG"):
        want = [("psum", "dp", RANKS, s * 4)]
    elif name == "DAWSessionMix":
        want = [("psum", "dp", RANKS, 3 * s * 4)]
    elif name.startswith("datacopy"):
        floats = fields["transfer_mib"] * 1024 * 1024 // 4
        want = [("all_gather", "dp", RANKS,
                 int(floats * int(name[8:10]) / 100) * 4)]
    elif fields.get("conv_edge_mode") == "bleed":
        halo = -(-(fields.get("ir_length", 1024) - 1) // s)
        want = [("all_gather", "dp", RANKS,
                 RANKS * min(halo, t // RANKS) * s * 4)]
    elif fields.get("neuralamp_dtype") == "int8":
        # one float a layer: the activation's max |x| over the ranks
        want = [("pmax", "dp", RANKS, 4)] * fields["neuralamp_layers"]
    else:
        want = []
    assert inv == want


# int8 NeuralAmp quantizes each layer's input with the whole batch's
# scale: on 2, 4 and 8 ranks its output is the one-rank run's bit for
# bit, its max error against the golden is the JAX package's at the same
# data_parallel (within INT8_MAX_ERROR_ATOL: the two packages' f32
# epilogues may round an output's last bit apart), and a round trip
# issues one pmax a layer.
INT8_IDS = [c[0] for c in CASES if c[2].get("neuralamp_dtype") == "int8"]
INT8_WORLDS = (2, 4)
INT8_MAX_ERROR_ATOL = 1e-6


@pytest.fixture(scope="module")
def int8_runs(runs):
    """{world: {id: run}} of the int8 cases at INT8_WORLDS ranks (one
    launch a world) and, from ``runs``, at RANKS."""
    cases = [(name, fields) for cid, name, fields in CASES
             if cid in INT8_IDS]
    out = {RANKS: {cid: runs[cid][1] for cid in INT8_IDS}}
    for world in INT8_WORLDS:
        got = spmd(ranks.dp_runs, world, "cpu", cases, "cpu",
                   timeout_s=SPAWN_TIMEOUT_S)
        out[world] = dict(zip(INT8_IDS, got))
    return out


@pytest.mark.parametrize("world", INT8_WORLDS + (RANKS,))
@pytest.mark.parametrize("cid", INT8_IDS)
def test_int8_quantizes_with_the_whole_batchs_scale(runs, int8_runs, cid,
                                                    world):
    _, name, fields = _case(cid)
    one, many = runs[cid][0], int8_runs[world][cid]
    assert not isinstance(many, str), many
    for k, v in outputs(one[1]).items():
        assert np.array_equal(v, many[1][k]), k
    rec = many[0]
    assert rec["validation"]["status"] == "SUCCESS"
    theirs = jax_host(name, fields, world)
    assert theirs["passed"]
    assert abs(rec["validation"]["max_error"]
               - theirs["max_error"]) <= INT8_MAX_ERROR_ATOL
    inv = [(c["kind"], c["axis_n"], c["bytes"])
           for c in rec["metadata"]["collectiveInventory"]]
    assert inv == [("pmax", world, 4)] * fields["neuralamp_layers"]
