"""``--dataParallel`` on gloo meshes of 2 and 4 ranks: the 21 sharded
benchmarks of ``test_torch_dataparallel.py`` (its ``CASES``, same toy
size) each validate and equal the port's one-rank run (bit for bit where
a rank's arithmetic is per track, within 1e-6 of the peak where a psum
reorders a sum or a batched FFT runs over fewer rows). Two cases more in
each launch:

* a modal bank of 48 modes onto 16 tracks, whose shards (24 or 12
  modes) are no multiple of T_out = 16, so each rank pads its head and
  tail with zero-amplitude modes to line up with the fold;
* datacopy2080 at 1 MiB, whose output floats (209,715) no mesh divides:
  set-up raises the JAX package's message.

One launch a mesh size (``parallel/ranks.py:dp_runs``).
"""

from __future__ import annotations

import numpy as np
import pytest
from test_torch_dataparallel import (
    CASES,
    FFT_NAMES,
    FFT_RTOL,
    PSUM_NAMES,
    PSUM_RTOL,
    SPAWN_TIMEOUT_S,
    TOY,
    outputs,
)

from gpuaudiobench_tpu.config import BenchConfig as JaxConfig
from gpuaudiobench_tpu.registry import create_benchmark as jax_create
from gpuaudiobench_tpu_torch.parallel import ranks
from gpuaudiobench_tpu_torch.parallel.launch import spmd

MESHES = (2, 4)
MISALIGNED = ("ModalFilterBank-48-modes", "ModalFilterBank",
              dict(TOY, modal_num_modes=48))
INDIVISIBLE = ("datacopy2080-1MiB", "datacopy2080", dict(TOY, transfer_mib=1))
ALL = CASES + [MISALIGNED]
IDS = [c[0] for c in ALL]


@pytest.fixture(scope="module")
def runs():
    """{(ranks, id): (one-rank run, run on that many ranks)}, and
    {ranks: the indivisible case's error}."""
    cases = [(name, fields) for _, name, fields in ALL]
    one = ranks.dp_runs(cases, device="cpu")
    out, errors = {}, {}
    for n in MESHES:
        *many, err = spmd(ranks.dp_runs, n, "cpu",
                          cases + [INDIVISIBLE[1:]], "cpu",
                          timeout_s=SPAWN_TIMEOUT_S)
        out.update({(n, cid): pair for cid, pair in zip(IDS, zip(one,
                                                                  many))})
        errors[n] = err
    return out, errors


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("cid", IDS)
def test_validates_and_equals_the_one_rank_run(runs, n, cid):
    name = next(c[1] for c in ALL if c[0] == cid)
    one, many = runs[0][(n, cid)]
    assert not isinstance(many, str), many
    assert many[0]["validation"]["status"] == "SUCCESS", many[0]["validation"]
    a, b = outputs(one[1]), outputs(many[1])
    assert sorted(a) == sorted(b)
    for k in a:
        if name in PSUM_NAMES or name in FFT_NAMES:
            rtol = PSUM_RTOL if name in PSUM_NAMES else FFT_RTOL
            peak = float(np.max(np.abs(a[k]))) or 1.0
            assert float(np.max(np.abs(a[k] - b[k]))) <= rtol * peak, k
        else:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("n", MESHES)
def test_misaligned_modal_shards_pad_to_the_fold(runs, n):
    """48 modes over n ranks: shard r starts at mode 48 r / n, which the
    fold of 16 tracks does not divide for some r; each rank's table holds
    its head padding, its modes and its tail padding."""
    one, many = runs[0][(n, MISALIGNED[0])]
    shapes = many[2]
    per = 48 // n
    heads = [(r * per) % 16 for r in range(n)]
    assert any(heads)
    for r, s in enumerate(shapes):
        padded = heads[r] + per
        assert s["_dev.amp"] == (padded + (-padded % 16),)
    assert many[0]["validation"]["status"] == "SUCCESS"


@pytest.mark.parametrize("n", MESHES)
def test_indivisible_output_floats_raise_the_jax_message(runs, n):
    _, name, fields = INDIVISIBLE
    want = (f"output floats (209715) must be divisible by --dataParallel "
            f"({n})")
    assert runs[1][n] == want
    jcfg = JaxConfig(transfer_mib=1, data_parallel=n, n_runs=1, warmup=0,
                     write_latencies=False, device_timing=False)
    with pytest.raises(ValueError) as e:
        jax_create(name, jcfg).setup()
    assert str(e.value) == want
