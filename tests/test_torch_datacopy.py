"""The PyTorch port's pinned staging and datacopy family against the JAX
package, on the CPU: ``data_transfer_op``, the golden past 2^24 floats,
the five benchmarks through both CLIs, ``stage_pinned`` and ``upload``.

The port's synthesized tail takes torch's float32 sin, the JAX op XLA's
(glibc's sinf on the CPU): they differ in the last place on a few percent
of the samples, so that tail is held within one float32 ulp of 1.0 / 2
(2^-24, the 1e-7 of the golden check), and everything else bit for bit.
"""

import contextlib
import dataclasses
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuaudiobench_tpu import cli as jax_cli
from gpuaudiobench_tpu import config as jax_config
from gpuaudiobench_tpu.models.datatransfer import (
    DataTransferBenchmark as JaxDataTransfer,
)
from gpuaudiobench_tpu.ops.elementwise import data_transfer_op as jax_op
from gpuaudiobench_tpu_torch import cli
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.models.datatransfer import (
    DATACOPY_CONFIGS,
    DataTransferBenchmark,
    transfer_golden,
)
from gpuaudiobench_tpu_torch.ops.elementwise import data_transfer_op
from gpuaudiobench_tpu_torch.utils import device as dev

CPU = torch.device("cpu")
SIN_ULP = 2.0 ** -24
NAMES = sorted(DATACOPY_CONFIGS)


def _x(n, seed=5):
    g = np.random.Generator(np.random.MT19937(seed))
    return g.random(n, dtype=np.float32)


@pytest.mark.parametrize("n_in,n_out", [(100, 4096), (4096, 4096),
                                        (5000, 333), (1, 70000)])
def test_data_transfer_op_matches_the_jax_op(n_in, n_out):
    x = _x(n_in)
    ours = data_transfer_op(torch.from_numpy(x), n_out).numpy()
    theirs = np.asarray(jax_op(jnp.asarray(x), n_out))
    assert ours.dtype == theirs.dtype == np.float32
    assert ours.shape == theirs.shape == (n_out,)
    n = min(n_in, n_out)
    np.testing.assert_array_equal(ours[:n], theirs[:n])
    np.testing.assert_array_equal(ours[:n], x[:n])
    if n_out > n_in:
        tail = np.abs(ours[n_in:] - theirs[n_in:])
        assert tail.max() <= SIN_ULP
        assert np.mean(tail == 0) > 0.9  # the same function, not a near one


def test_data_transfer_op_returns_a_fresh_tensor():
    x = torch.from_numpy(_x(64))
    for n_out in (64, 10):
        y = data_transfer_op(x, n_out)
        y[0] = -1.0
        assert x[0] != -1.0


def test_golden_past_2_24_matches_the_jax_golden():
    """datacopy0199 at a 100 MiB pool writes 25,952,256 floats: the
    float32 index past 2^24 must round as np.arange's does, or the sin's
    argument is off by ~1e-3 there."""
    name = "datacopy0199"
    jb = JaxDataTransfer(jax_config.BenchConfig(transfer_mib=100), name)
    jb.setup()
    ours = DataTransferBenchmark(BenchConfig(transfer_mib=100), CPU, name)
    ours.setup()
    assert ours.output_size == jb.output_size == 25_952_256 > 2 ** 24
    assert ours.input_size == jb.input_size
    np.testing.assert_array_equal(ours.golden, jb.golden)
    diff = np.abs(ours.host_output - jb.golden)
    assert diff.max() <= 1e-7
    assert diff[2 ** 24:].max() <= 1e-7
    assert ours.validate().passed


def test_transfer_golden_is_the_reference_formula():
    x = _x(10)
    g = transfer_golden(x, 40)
    np.testing.assert_array_equal(g[:10], x)
    idx = np.arange(40, dtype=np.float32)
    np.testing.assert_array_equal(
        g[10:], (0.5 + 0.5 * np.sin(idx * np.float32(0.001)))[10:])


def _run(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, **kw)
    lines = buf.getvalue().splitlines()
    start = lines.index("{")
    end = len(lines) - 1 - lines[::-1].index("}")
    return rc, json.loads("\n".join(lines[start:end + 1]))


def _paths(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _paths(v, prefix + k + ".")
    return out


# The port's JSON keys beyond the reference's on the CPU: the pacer that
# ran under DAW-sim (on a CUDA device also ``device.power_limit``).
PORT_ADDITIONS = {"deadline.pacer"}
# The reference's keys the port does not write: the relay's co-located
# projection (ROADMAP "Not ported") and, on the CPU, no roofline.
PORT_OMISSIONS_PREFIXES = ("metadata.projection",)


@pytest.mark.parametrize("name", NAMES)
def test_datacopy_through_both_clis(name):
    argv = ["--benchmark", name, "--transferMiB", "1", "--nRuns", "3",
            "--warmup", "1", "--dawsim", "--json"]
    rc, ours = _run(cli.main, argv, device="cpu")
    rc_j, theirs = _run(lambda a: jax_cli.main(a), argv)
    assert rc == rc_j == 0
    assert ours["validation"]["status"] == theirs["validation"]["status"] \
        == "SUCCESS"
    assert ours["validation"]["samples_checked"] == \
        theirs["validation"]["samples_checked"]
    mine, ref = _paths(ours), _paths(theirs)
    assert mine - ref == PORT_ADDITIONS, mine - ref
    missing = {p for p in ref - mine
               if not p.startswith(PORT_OMISSIONS_PREFIXES)}
    assert missing == set(), missing
    assert ours["configuration"] == theirs["configuration"]
    assert ours["performance"]["bytes_processed"] == \
        theirs["performance"]["bytes_processed"]
    for key in ("inputFloats", "outputFloats", "inputMiB", "outputMiB"):
        assert ours["metadata"][key] == theirs["metadata"][key]
    assert ours["metadata"]["transferMemoryClass"] == {
        "pinned_supported": False, "h2d_path_used": "pageable"}
    assert set(theirs["metadata"]["transferMemoryClass"]) >= {
        "pinned_supported", "h2d_path_used"}


@pytest.mark.parametrize("name", NAMES)
def test_datacopy_models_match_the_reference(name):
    jcfg = jax_config.BenchConfig(transfer_mib=1, n_runs=2, warmup=1)
    ref = JaxDataTransfer(jcfg, name)
    ref.setup()
    ours = DataTransferBenchmark(
        BenchConfig(**{f.name: getattr(jcfg, f.name)
                       for f in dataclasses.fields(BenchConfig)}), CPU, name)
    ours.setup()
    assert ours.cost_model() == ref.cost_model()
    assert ours.transfer_model() == ref.transfer_model()
    assert ours.bytes_processed() == ref.bytes_processed()
    assert ours.total_elements() == ref.total_elements()
    np.testing.assert_array_equal(ours.host_input, ref.host_input)
    assert ours.stream_body() is None
    assert ours.validate().passed


def test_stage_pinned_returns_none_on_the_cpu():
    assert dev.stage_pinned(np.zeros(4, np.float32), CPU) is None


def test_stage_pinned_raises_on_cuda_without_pinned_memory():
    """This CPU build of torch has no pinned allocator: a CUDA device
    descriptor raises, never a pageable stand-in."""
    with pytest.raises(RuntimeError):
        dev.stage_pinned(np.zeros(4, np.float32), torch.device("cuda:0"))


def test_upload_copies():
    a = np.arange(6, dtype=np.float32)
    t = dev.upload(a, CPU)
    t[0] = 9.0
    assert a[0] == 0.0
    src = torch.ones(3)
    u = dev.upload(src, CPU)
    u[0] = 5.0
    assert src[0] == 1.0
