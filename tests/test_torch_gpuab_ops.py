"""The eight kernels that became ``gpuab`` operators last (``ops/gpuab.py``,
``csrc/torch_ops.cc``): the modal resonator, the IIR block-state kernel and
chain cascade, the RndMem gather, the DWG block, the FDTD field form's
plane kernel and the two speed-of-light chains; and the kernel that
buckets the field form's per-track receivers by plane on the card
(``fdtd_receiver_buckets``). On the CPU, for each:

* ``torch.library.opcheck`` of its operator on CPU tensors (schema, the
  mutated arguments, the fake against the CPU implementation, the
  autograd registration, AOT dispatch);
* a ``torch.export`` of a small step through its wrapper: the program
  holds the operator as a node (no graph break, no unrolled twin), a
  trace counts no launch, and the exported program's outputs (and, for
  the DWG block, the rails it writes in place) equal the wrapper's eager
  CPU call bit for bit;
* the wrapper against the JAX function it stands for, on the same numpy
  inputs, chained over blocks, at the tolerance the existing tests hold
  its twin to: the gather bit for bit (``tests/test_torch_rndmem.py``),
  the block-state form 1e-5 and the chain cascade 1e-5 absolute
  (``tests/test_torch_iir_ops.py``), the DWG output 1e-5 and rails 1e-6
  (``tests/test_torch_dwg.py``), the field form 1e-6
  (``tests/test_torch_fdtd.py``), the resonator 1e-5 of the peak and its
  states 1e-5 (``tests/test_torch_modal_res.py``), the chains 1e-5
  (``tests/test_torch_speedoflight.py``). Pallas kernels run in interpret
  mode, as the JAX package's own tests run them.

The per-track field step takes receivers off the grid too, which both
packages read as XLA's gather does, and its program takes the receivers
as an input; the bucketing operator's CPU implementation gives
``receiver_csr``'s buckets on the normalized cells.

The library builds here with g++ against PyTorch's headers, without its
CUDA part: every operator has its schema, its fake and its CPU twin.
"""

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpuaudiobench_tpu.ops import fdtd3d as jfdtd
from gpuaudiobench_tpu.ops import iir as jiir
from gpuaudiobench_tpu.ops import speedoflight as jsol
from gpuaudiobench_tpu.ops.dwg import dwg_block as jax_dwg_block
from gpuaudiobench_tpu.ops.modal_pallas import (
    modal_res_step as jax_res_step,
    res_init as jax_res_init,
    stream_tile,
)
from gpuaudiobench_tpu.ops.rndmem import rndmem_gather as jax_gather
from gpuaudiobench_tpu.utils.data import biquad_lowpass_coefficients
from gpuaudiobench_tpu_torch.ops import (
    dwg,
    fdtd3d,
    gpuab,
    iir,
    modal,
    rndmem,
    speedoflight,
)

NEW_OPS = ("modal_res_launch", "iir_blockstate_launch",
           "iir_cascade_chain_launch", "rndmem_gather_launch",
           "dwg_block_launch", "fdtd_field_planes_launch",
           "fma_chain_launch", "fma_vmem_launch")
MODULES = (modal, iir, rndmem, dwg, fdtd3d, speedoflight)
ROOM = 8


@dataclasses.dataclass
class Case:
    """One operator's small step: ``inputs`` (numpy), ``step`` the wrapper
    on their tensors (what the export traces), ``op_args`` the operator's
    own arguments for opcheck, ``jax`` the JAX function on the same numpy
    inputs, ``blocks`` chained, compared by ``check``."""

    op: str
    inputs: Tuple[np.ndarray, ...]
    step: Callable
    op_args: Callable
    jax: Callable
    check: Callable
    blocks: int = 3
    # Inputs the step writes in place (the DWG rails): index -> True.
    mutated: Tuple[int, ...] = ()
    # How a block's outputs feed the next block's inputs (None: the same).
    carry: Callable = None


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(atol, rel=False):
    def check(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert got.shape == want.shape
        scale = np.abs(want).max() if rel else 1.0
        assert np.abs(got - want).max() <= atol * scale
    return check


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _signal(rng, tracks, s):
    return (rng.random((tracks, s), dtype=np.float32) * 2 - 1).astype(
        np.float32)


def _res_case(rng) -> Case:
    m, s, t_out = 256, 32, 8
    amp = rng.random(m, dtype=np.float32)
    w = 2 * np.pi * rng.random(m, dtype=np.float32) * 0.45
    cw, sw = np.cos(w).astype(np.float32), np.sin(w).astype(np.float32)
    re = (rng.random(m, dtype=np.float32) * 2 - 1).astype(np.float32)
    im = (rng.random(m, dtype=np.float32) * 2 - 1).astype(np.float32)
    eps, y, q = (np.asarray(a) for a in jax_res_init(cw, sw, amp * re,
                                                      amp * im))
    tile = stream_tile(m, t_out)

    def step(e, yy, qq):
        return modal.modal_res_step(e, yy, qq, s, t_out)

    def ref(e, yy, qq):
        with pltpu.force_tpu_interpret_mode():
            return jax_res_step(e, yy, qq, s, t_out, tile)

    def check(got, want):
        _close(1e-5, rel=True)(got[0], want[0])
        _close(1e-5)(got[1], want[1])
        _close(1e-5)(got[2], want[2])

    return Case("modal_res_launch", (eps, y, q), step,
                lambda e, yy, qq: (e, yy, qq, s, t_out, True, True, 0, 0, 0),
                ref, check, carry=lambda inp, out: (inp[0], out[1], out[2]))


def _blockstate_case(rng) -> Case:
    tracks, s, m = 8, 128, 16
    c = np.array(biquad_lowpass_coefficients(0.25), np.float32)
    taps, u = jiir.blockstate_tables(c, m)
    x = _signal(rng, tracks, s)
    z = (rng.random((tracks, 2), dtype=np.float32) - 0.5).astype(np.float32)

    def check(got, want):
        for g, w in zip(got, want):
            _close(1e-5)(g, w)

    return Case("iir_blockstate_launch", (x, c, np.asarray(taps),
                                          np.asarray(u), z),
                iir.iir_biquad_blockstate,
                lambda *a: a,
                lambda *a: jiir.iir_biquad_blockstate(*a), check,
                carry=lambda inp, out: (*inp[:4], out[1]))


def _chain_case(rng) -> Case:
    k, tracks, s = 4, 8, 32
    c = np.array([biquad_lowpass_coefficients(0.25 - 0.0125 * i)
                  for i in range(k)], np.float32)
    x = _signal(rng, tracks, s)
    z = ((rng.random((k, tracks, 2), dtype=np.float32) - 0.5) * 0.2
         ).astype(np.float32)

    def ref(xx, cc, zz):
        with pltpu.force_tpu_interpret_mode():
            return jiir.iir_cascade_pallas_chain(xx, cc, zz,
                                                 track_block=tracks)

    def check(got, want):
        for g, w in zip(got, want):
            _close(1e-5)(g, w)

    sc = iir.chain_schedule(tracks, s)
    return Case("iir_cascade_chain_launch", (x, c, z), iir.iir_cascade_chain,
                lambda *a: (*a, 1, sc.grid, sc.chunks), ref, check,
                carry=lambda inp, out: (inp[0], inp[1], out[1]))


def _rndmem_case(rng) -> Case:
    pool_len, s = 4096, 64
    pool = rng.random(pool_len, dtype=np.float32)
    ph = np.array([0, 1, 513, pool_len - s, pool_len - 1, -1, -700,
                   2 ** 31 - 1, 127, 1000], np.int32)

    def ref(p, h):
        return jax_gather(p, h, np.zeros((h.shape[0], s), np.float32))

    return Case("rndmem_gather_launch", (pool, ph),
                lambda p, h: rndmem.rndmem_gather(p, h, s),
                lambda p, h: (p, h, s), ref, _equal, blocks=1)


def _dwg_case(rng) -> Case:
    s = 48
    lengths = np.array([100, 7, 48, 49, 64, 13, 200, 47], np.int32)
    g, lmax = len(lengths), int(lengths.max()) + 3
    params = [lengths, (lengths // 4).astype(np.int32),
              (3 * lengths // 4).astype(np.int32),
              rng.random(g, dtype=np.float32),
              np.full(g, 0.99, np.float32), np.full(g, 0.9999, np.float32)]
    x = _signal(rng, 1, s)[0]
    fwd = (rng.random((g, lmax), dtype=np.float32) * 0.1).astype(np.float32)
    bwd = (rng.random((g, lmax), dtype=np.float32) * 0.1).astype(np.float32)
    sc = dwg.dwg_schedule(g, s, lmax)

    def check(got, want):
        _close(1e-5)(got[0], want[0])
        _close(1e-6)(got[1], want[1])
        _close(1e-6)(got[2], want[2])

    return Case("dwg_block_launch", (x, fwd, bwd, *params), dwg.dwg_block,
                lambda *a: (*a, sc.segments, sc.groups, sc.update_blocks),
                jax_dwg_block, check, mutated=(1, 2),
                carry=lambda inp, out: (inp[0], out[1], out[2], *inp[3:]))


def _field_case(rng, per_track: bool) -> Case:
    n, s, tracks = fdtd3d.grid_n(ROOM), 16, 6
    src, rcv = fdtd3d.source_pos(ROOM), fdtd3d.receiver_pos(ROOM)
    x = _signal(rng, tracks, s)
    fields = tuple(np.asarray(f) for f in fdtd3d.zero_fields(n))
    xs, ys, zs = fdtd3d.receiver_line(tracks, n)
    flat = ((xs.astype(np.int64) * n + ys) * n + zs).astype(np.int32)
    # two tracks off the grid: one past its end, one negative
    flat[1], flat[4] = n ** 3 + 40, -3
    plan = fdtd3d.plane_schedule(n, "field")

    def step(xx, p, vx, vy, vz, *rows):
        return fdtd3d.fdtd3d_block_field(xx, p, vx, vy, vz, src, rcv,
                                         receivers=rows[0] if rows else None)

    def ref(xx, p, vx, vy, vz, *rows):
        if rows:
            return jfdtd.fdtd3d_block_multircv(xx, p, vx, vy, vz, rows[0],
                                               source=src)
        return jfdtd.fdtd3d_block(xx, p, vx, vy, vz, source=src,
                                  receiver=rcv)

    def op_args(xx, p, vx, vy, vz, *rows):
        extra = (fdtd3d.receiver_buckets_plain(rows[0], n) if rows
                 else (None, None, None))
        return (fdtd3d.source_row(xx), p, vx, vy, vz, *extra, tracks,
                fdtd3d.flat_cell(src, n), fdtd3d.flat_cell(rcv, n),
                fdtd3d.K1, fdtd3d.K2, fdtd3d.ABSORB, fdtd3d.F_OUTPUT_SCALE,
                fdtd3d.range_starts(plan))

    def check(got, want):
        for g, w in zip(got, want):
            _close(1e-6)(g, w)

    inputs = (x, *fields) + ((flat,) if per_track else ())
    return Case("fdtd_field_planes_launch", inputs, step, op_args, ref,
                check, blocks=2,
                carry=lambda inp, out: (inp[0], *out[1:], *inp[5:]))


def _fma_case(rng, name: str) -> Case:
    k = 24
    x = _signal(rng, 13, 100)
    jax_fn = (jsol.fma_chain_pallas if name == "fma_chain"
              else jsol.fma_vmem_pallas)

    def ref(xx):
        with pltpu.force_tpu_interpret_mode():
            return jax_fn(xx, k)

    return Case(f"{name}_launch", (x,),
                lambda xx: getattr(speedoflight, name)(xx, k),
                lambda xx: (xx, k, float(np.float32(speedoflight.FMA_M)),
                            float(np.float32(speedoflight.FMA_C))),
                ref, _close(1e-5), blocks=1)


CASES: Dict[str, Callable] = {
    "modal_res": _res_case,
    "iir_blockstate": _blockstate_case,
    "iir_cascade_chain": _chain_case,
    "rndmem_gather": _rndmem_case,
    "dwg_block": _dwg_case,
    "fdtd_field": lambda rng: _field_case(rng, False),
    "fdtd_field_receivers": lambda rng: _field_case(rng, True),
    "fma_chain": lambda rng: _fma_case(rng, "fma_chain"),
    "fma_vmem": lambda rng: _fma_case(rng, "fma_vmem"),
}


@pytest.fixture(scope="module")
def ops():
    return gpuab.load()


def _tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def test_the_library_has_all_fourteen_operators(ops):
    """The fourteen launch operators, and the receivers' bucketing."""
    launch = [name for name in gpuab.OPS if name.endswith("_launch")]
    assert len(launch) == 14 and len(set(launch)) == 14
    assert len(gpuab.OPS) == 15 and len(set(gpuab.OPS)) == 15
    assert set(gpuab.OPS) - set(launch) == {"fdtd_receiver_buckets"}
    assert set(NEW_OPS) <= set(gpuab.OPS)
    for name in gpuab.OPS:
        qualified = f"gpuab::{name}"
        assert getattr(ops, name).default._schema.name == qualified
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qualified,
                                                              "CPU")
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qualified,
                                                              "Meta")
    # Only the DWG rails are written in place; every other operator is
    # functional.
    for name in gpuab.OPS:
        schema = str(getattr(ops, name).default._schema)
        assert ("!" in schema) == (name == "dwg_block_launch"), schema
    sig = str(ops.dwg_block_launch.default._schema)
    assert "Tensor(a!) fwd" in sig and "Tensor(b!) bwd" in sig


@pytest.mark.parametrize("case", sorted(CASES))
def test_opcheck(ops, rng, case):
    c = CASES[case](rng)
    args = c.op_args(*(_t(a) for a in c.inputs))
    torch.library.opcheck(getattr(ops, c.op).default, args)


class _Step(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


# Per-track receivers are bucketed by plane by an operator of their own,
# so a program holding them traces like the broadcast receiver's.
EXPORT_CASES = sorted(CASES)


def test_export_refuses_per_track_receivers(ops, rng):
    """What the field step refuses eagerly it refuses while traced:
    receivers that are no int32 (tracks,) tensor (their values are never
    refused: ``test_export_equals_the_eager_call`` exports two off the
    grid)."""
    c = CASES["fdtd_field_receivers"](rng)
    inputs = [_t(a) for a in c.inputs]
    for bad in (inputs[-1].to(torch.int64), inputs[-1][:-1].clone()):
        with pytest.raises(ValueError, match="receivers must be int32"):
            torch.export.export(_Step(c.step), tuple(inputs[:-1] + [bad]))


@pytest.mark.parametrize("case", EXPORT_CASES)
def test_export_equals_the_eager_call(ops, rng, case):
    c = CASES[case](rng)
    before = [dict(m.KERNEL_LAUNCHES) for m in MODULES]
    traced_in = [_t(a) for a in c.inputs]
    prog = torch.export.export(_Step(c.step), tuple(traced_in))
    assert [dict(m.KERNEL_LAUNCHES) for m in MODULES] == before
    graph = str(prog.graph)
    assert f"gpuab.{c.op}" in graph
    calls = [n for n in prog.graph.nodes if n.op == "call_function"]
    assert len(calls) < 40  # the kernel is one node, not a sample loop
    eager_in = [_t(a) for a in c.inputs]
    exported_in = [_t(a) for a in c.inputs]
    want = _tuple(c.step(*eager_in))
    got = _tuple(prog.module()(*exported_in))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for i in c.mutated:
        assert torch.equal(exported_in[i], eager_in[i])
        assert not torch.equal(exported_in[i], _t(c.inputs[i]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapper_matches_the_jax_function(rng, case):
    c = CASES[case](rng)
    ours = tuple(_t(a) for a in c.inputs)
    theirs = tuple(np.array(a) for a in c.inputs)
    before = [dict(m.KERNEL_LAUNCHES) for m in MODULES]
    for _ in range(c.blocks):
        got = tuple(o.clone() for o in _tuple(c.step(*ours)))
        want = tuple(np.asarray(w) for w in _tuple(c.jax(*theirs)))
        c.check([g.numpy() for g in got], want)
        if c.carry is not None:
            ours = c.carry(ours, got)
            theirs = c.carry(theirs, want)
    # An eager CPU call runs the twin: no kernel launch is counted.
    assert [dict(m.KERNEL_LAUNCHES) for m in MODULES] == before


# Receivers of 7 tracks in an 8^3 grid: in the grid, past its end, and
# negative (wrapped once, then clamped), several to one plane.
BUCKET_RECEIVERS = [100, 511, 512, -1, -600, 7, 130]


def test_receiver_buckets_opcheck(ops):
    torch.library.opcheck(ops.fdtd_receiver_buckets.default,
                          (torch.tensor(BUCKET_RECEIVERS, dtype=torch.int32),
                           8))


@pytest.mark.parametrize("tracks,n", [(7, 8), (1, 3), (300, 10)])
def test_receiver_buckets_are_receiver_csrs(ops, rng, tracks, n):
    """The CPU implementation of ``fdtd_receiver_buckets``: the cells as
    ``normalize_receivers`` reads them, and plane by plane the rows
    ``receiver_csr`` buckets there (as sets: the kernel's order within a
    plane is its atomics')."""
    raw = (np.array(BUCKET_RECEIVERS, np.int32) if tracks == 7 else
           rng.integers(-2 * n ** 3, 2 * n ** 3, tracks).astype(np.int32))
    if tracks == 7:
        n = 8
    rcv = torch.from_numpy(raw)
    cells, order, starts = ops.fdtd_receiver_buckets(rcv, n)
    assert all(t.dtype == torch.int32 for t in (cells, order, starts))
    want_cells = fdtd3d.normalize_receivers(rcv, n)
    assert torch.equal(cells, want_cells.to(torch.int32))
    ref_order, ref_starts = fdtd3d.receiver_csr(want_cells.numpy(), n)
    assert starts.tolist() == ref_starts
    for b in range(n):
        lo, hi = ref_starts[b], ref_starts[b + 1]
        assert (sorted(order[lo:hi].tolist())
                == sorted(ref_order[lo:hi].tolist())), b
    assert sorted(order.tolist()) == list(range(tracks))


def test_receiver_buckets_export_equals_the_eager_call(ops):
    rcv = torch.tensor(BUCKET_RECEIVERS, dtype=torch.int32)
    before = dict(fdtd3d.KERNEL_LAUNCHES)
    prog = torch.export.export(
        _Step(lambda r: fdtd3d.receiver_buckets(r, 8)), (rcv,))
    assert fdtd3d.KERNEL_LAUNCHES == before
    assert "gpuab.fdtd_receiver_buckets" in str(prog.graph)
    got = prog.module()(rcv.clone())
    for g, w in zip(got, fdtd3d.receiver_buckets(rcv, 8)):
        assert torch.equal(g, w)
    assert fdtd3d.KERNEL_LAUNCHES == before  # eager on the CPU: the twin


def test_no_ops_module_launches_a_kernel_through_ctypes():
    """Every kernel launch goes through an operator: no ``ops/*.py`` calls
    a C launch entry on a ctypes handle (``lib.<name>_launch(...)``,
    ``_lib().<name>_launch``, ``getattr(lib, "..._launch")``), but the
    cluster-barrier probe, a measurement; the handles serve the schedule
    and capacity queries."""
    import re
    from pathlib import Path

    allowed = {"fdtd_cluster_probe_launch"}
    direct = re.compile(r"\b(?:lib|_lib\(\))\s*\.\s*(\w+_launch)\b")
    by_name = re.compile(r"getattr\(\s*(?:lib|_lib\(\))\s*,\s*([^)]*)\)")
    for path in sorted(Path(gpuab.__file__).parent.glob("*.py")):
        text = path.read_text()
        for m in direct.finditer(text):
            assert m.group(1) in allowed, (path.name, m.group(0))
        for m in by_name.finditer(text):
            assert "_launch" not in m.group(1), (path.name, m.group(0))
    assert not hasattr(fdtd3d, "_launch")
    for mod in (rndmem, dwg, speedoflight):
        assert not hasattr(mod, "_lib"), mod.__name__


def test_receivers_ab_needs_the_card(capsys):
    """The receivers' A/B tool measures on the card only: here its worker
    refuses and it exits 1 naming the reason."""
    from gpuaudiobench_tpu_torch.tools import receivers_ab

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert receivers_ab.main([]) == 1
    assert "CUDA requested" in capsys.readouterr().err


def test_binding_ab_needs_the_card(capsys):
    """The A/B tool measures on the card only: here its worker refuses and
    it exits 1 naming the reason."""
    from gpuaudiobench_tpu_torch.tools import binding_ab

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert binding_ab.main([]) == 1
    assert "CUDA requested" in capsys.readouterr().err
