"""The port's mesh, collectives and SPMD launcher
(``gpuaudiobench_tpu_torch/parallel/{mesh,collectives,launch}.py``)
against the JAX package's mesh helpers and ``jax.lax``'s collectives on
the conftest's 8-device CPU mesh.

The port's side runs on gloo ranks spawned by ``launch.spmd`` (one spawn
a world size, every spawn with a hard timeout). Collectives move data
without arithmetic but psum's additions, so all_gather, pmax, ppermute
and the axis indices are held bit for bit, psum within 1e-6 of the peak
(the sum's order may differ).
"""

import time

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from gpuaudiobench_tpu.models import multichip_bench as jbench
from gpuaudiobench_tpu.parallel import mesh as jmesh
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.parallel import collectives as col
from gpuaudiobench_tpu_torch.parallel import mesh
from gpuaudiobench_tpu_torch.parallel import ranks
from gpuaudiobench_tpu_torch.parallel.launch import spmd
from gpuaudiobench_tpu_torch.registry import create_benchmark

AXES = mesh.AXES
SPAWN_TIMEOUT_S = 120
MESHES8 = [(2, 2, 2), (8, 1, 1), (1, 2, 4)]


@pytest.mark.parametrize("n", range(1, 17))
def test_factor3_is_the_references(n):
    assert mesh._factor3(n) == jmesh._factor3(n)


@pytest.mark.parametrize("spec", ["2,2,2", "1,1,1", " 8, 1 ,1", "2,2",
                                  "2,0,1", "a,b,c", "1,1,1,1", "", "-1,1,1"])
def test_parse_mesh_is_the_references(spec):
    try:
        want = jbench.parse_mesh(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.parse_mesh(spec)
        assert str(got.value) == str(e)
        return
    assert mesh.parse_mesh(spec) == want


def test_one_rank_mesh_needs_no_process_group():
    m = mesh.build_mesh((1, 1, 1), AXES, torch.device("cpu"))
    assert m.size == 1 and m.coords == {"dp": 0, "tp": 0, "sp": 0}
    x = torch.arange(6.0).reshape(2, 3)
    col.COLLECTIVES.clear()
    assert col.all_gather(x, m, "sp", 1) is x
    assert col.psum(x, m, "tp") is x
    assert col.pmax(x, m, "tp") is x
    assert col.ppermute(x, m, "dp", col.ring(1)) is x
    assert col.unshard(x, m, ("dp", "sp")) is x
    assert col.COLLECTIVES == []


def test_mesh_too_large_raises_the_references_message():
    with pytest.raises(ValueError,
                       match=r"--mesh 64x1x1 needs 64 devices; 8 available"):
        mesh.build_mesh((64, 1, 1), AXES, torch.device("cpu"))
    with pytest.raises(ValueError, match="needs a process group of 2"):
        mesh.build_mesh((2, 1, 1), AXES, torch.device("cpu"))


def _x(shape, seed=3):
    g = np.random.default_rng(seed)
    return g.standard_normal((shape[0] * 2, shape[1] * 3,
                              shape[2] * 4)).astype(np.float32)


def _jax_collectives(shape, x):
    jm = JaxMesh(np.asarray(jax.devices()[:8]).reshape(shape), AXES)
    spec = P(*AXES)

    def run(fn, out_spec):
        return np.asarray(jax.jit(shard_map(
            fn, mesh=jm, in_specs=spec, out_specs=out_spec,
            check_vma=False))(x))

    res = {}
    for dim, axis in enumerate(AXES):
        n = jm.shape[axis]
        rest = P(*[None if d == dim else a for d, a in enumerate(AXES)])
        res[f"all_gather {axis}"] = run(
            lambda v, a=axis, d=dim: jax.lax.all_gather(v, a, axis=d,
                                                        tiled=True), rest)
        res[f"psum {axis}"] = run(lambda v, a=axis: jax.lax.psum(v, a), rest)
        res[f"ring {axis}"] = run(
            lambda v, a=axis, n=n: jax.lax.ppermute(
                v, a, [(i, (i + 1) % n) for i in range(n)]), spec)
        if n > 1:
            res[f"chain {axis}"] = run(
                lambda v, a=axis, n=n: jax.lax.ppermute(
                    v, a, [(i, i + 1) for i in range(n - 1)]), spec)
    res["axis_index"] = np.asarray(jax.jit(shard_map(
        lambda v: jax.numpy.stack(
            [jax.lax.axis_index(a) for a in AXES])[None, None, None],
        mesh=jm, in_specs=spec, out_specs=P(*AXES, None),
        check_vma=False))(x))
    return res


@pytest.fixture(scope="module")
def port8():
    """The collectives of the port on 8 gloo ranks, one spawn for the
    three meshes."""
    x = _x((8, 8, 8))
    return x, spmd(ranks.collectives_check, 8, "cpu", MESHES8, x, "cpu",
                   timeout_s=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("k", range(len(MESHES8)))
def test_collectives_equal_jax_lax_on_8_ranks(port8, k):
    x, results = port8
    shape = MESHES8[k]
    ours, ref = results[k], _jax_collectives(shape, x)
    for key, want in ref.items():
        got = ours[key]
        assert got.shape == want.shape, key
        if key.startswith("psum"):
            peak = float(np.abs(want).max())
            assert np.abs(got - want).max() <= 1e-6 * peak, key
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("k", range(len(MESHES8)))
def test_one_member_axes_are_the_identity_and_silent(port8, k):
    x, results = port8
    shape, ours = MESHES8[k], results[k]
    for axis, n in zip(AXES, shape):
        if n == 1:
            for op in ("all_gather", "psum", "ring", "chain"):
                np.testing.assert_array_equal(ours[f"{op} {axis}"], x)
    # Four collectives an axis of more than one member, none on the others.
    kinds = [(r["kind"], r["axis"]) for r in ours["records"]]
    want = [(kind, a) for a, n in zip(AXES, shape) if n > 1
            for kind in ("all_gather", "psum", "ppermute", "ppermute")]
    assert kinds == want


def _jax_pmax(shape, x):
    jm = JaxMesh(np.asarray(jax.devices()[:8]).reshape(shape), AXES)
    res = {}
    for dim, axis in enumerate(AXES):
        rest = P(*[None if d == dim else a for d, a in enumerate(AXES)])
        res[f"pmax {axis}"] = np.asarray(jax.jit(shard_map(
            lambda v, a=axis: jax.lax.pmax(v, a), mesh=jm,
            in_specs=P(*AXES), out_specs=rest, check_vma=False))(x))
    return res


@pytest.mark.parametrize("k", range(len(MESHES8)))
def test_pmax_equals_jax_lax_pmax_on_8_ranks(port8, k):
    """``collectives.pmax`` along each axis of each mesh: bit for bit
    ``jax.lax.pmax`` (a max is exact), its input on a one-member axis, and
    one record of the shard's bytes for each axis of more than one
    member."""
    x, results = port8
    shape, ours = MESHES8[k], results[k]
    for key, want in _jax_pmax(shape, x).items():
        np.testing.assert_array_equal(ours[key], want, err_msg=key)
    for axis, n in zip(AXES, shape):
        if n == 1:
            np.testing.assert_array_equal(ours[f"pmax {axis}"], x)
    shard = x.size // 8 * 4
    want = [("pmax", a, n, shard) for a, n in zip(AXES, shape) if n > 1]
    assert [(r["kind"], r["axis"], r["axis_n"], r["bytes"])
            for r in ours["pmax records"]] == want


def test_open_chain_gives_its_first_member_zeros(port8):
    x, results = port8
    chain = results[0]["chain tp"]  # (2, 2, 2): tp index 0 gets zeros
    w = x.shape[1] // 2
    assert not chain[:, :w].any()
    np.testing.assert_array_equal(chain[:, w:], x[:, :w])


def test_a_rank_that_skips_a_collective_fails_the_launch_in_time():
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        spmd(ranks.skip_collective, 2, "cpu", 1, timeout_s=6)
    assert time.monotonic() - t0 < 60


def test_a_rank_that_raises_fails_the_launch_with_its_traceback():
    with pytest.raises(RuntimeError,
                       match=r"(?s)rank [01] of 2 failed.*mesh 3x1x1 != 2"):
        spmd(ranks.collectives_check, 2, "cpu", [(3, 1, 1)], _x((2, 1, 1)),
             "cpu", timeout_s=SPAWN_TIMEOUT_S)


def test_spmd_refuses_cuda_ranks_without_the_cards():
    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has two cards")
    with pytest.raises(ValueError, match="need 2 CUDA devices"):
        spmd(ranks.skip_collective, 2, "cuda", 0)


@pytest.mark.parametrize("name", ["MultiChipSuite", "ICIBandwidth"])
def test_benchmark_setup_refuses_a_mesh_larger_than_the_devices(name):
    cfg = BenchConfig(mesh="64,1,1", n_runs=1, warmup=0,
                      write_latencies=False, device_timing=False)
    b = create_benchmark(name, cfg, torch.device("cpu"))
    with pytest.raises(ValueError, match="needs 64 devices; 8 available"):
        b.setup()
