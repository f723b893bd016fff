"""Export the benchmarks' device programs as AOTInductor packages for the
native runner (``csrc/native_runner.cc``).

The port's counterpart of the repo-level ``tools/export_stablehlo.py``:
the same eight names, the same inputs at ``BenchConfig``'s defaults (128
tracks, 512 samples), each program built from the port's own functions.
For each name it writes

* ``<name>.pt2``: ``torch.export`` of the function, compiled and packaged
  by AOTInductor (``torch._inductor.aoti_compile_and_package``). Inductor
  compiles the plain tensor code, as XLA did for the JAX exporter; the
  hand-written kernels enter only as the ``torch.ops.gpuab`` operators
  (``ops/gpuab.py``), which the package calls through the dispatcher;
* ``<name>.spec``: a ``#`` line, then ``f32 d0 d1 ...`` for each input, the
  JAX exporter's format.

It writes no ``compile_options.pb``: that is PJRT's compile request, and an
AOTInductor package is compiled already.

Usage:
  python -m gpuaudiobench_tpu_torch.tools.export_programs --out DIR [name ...]
  # names: modal_pallas fdtd3d_pallas gain iirfilter modal conv1d partconv
  # session (default: all); --device cpu exports for the CPU

The names ``modal_pallas`` and ``fdtd3d_pallas`` are the JAX exporter's,
kept so that one script drives both exporters: here they are the modal
rotation kernel at the headline shape (1,048,576 modes onto 32 tracks)
and the FDTD divergence form at room 50 (the cluster route). ``iirfilter``,
``modal`` and ``conv1d`` are XLA forms in the JAX exporter; the port has
no XLA form, and its harness runs the kernels, so the kernels are what it
exports. ``session`` bakes the benchmark's four staggered low-passes in as
constants, as the JAX exporter's ``_session_pinned`` does: the runner seeds
every input with LCG noise, and noise in a recursive filter's
coefficients diverges within a block.

``lcg_inputs`` makes the runner's inputs in Python, bit for bit: the
LCG of ``native/pjrt_runner.cc:NextRand`` from seed 42, element after
element and input after input, f32 values in [-1, 1), i32 values by its
S32 rule.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gpuaudiobench_tpu_torch.config import BenchConfig

NAMES = ("modal_pallas", "fdtd3d_pallas", "gain", "iirfilter", "modal",
         "conv1d", "partconv", "session")
HEADLINE_MODES = 1024 * 1024
HEADLINE_TRACKS = 32
FDTD_TRACKS = 128
CONV_IR = 1024
PARTITIONS = 94  # the 1 s IR (48,000 taps) in 512-sample partitions
SESSION_STAGES = 4
SEED = 42

Shape = Tuple[int, ...]
Spec = List[Tuple[str, Shape]]


def session_coefficients() -> np.ndarray:
    """The session benchmark's EQ: four staggered low-passes, (4, 5)."""
    from gpuaudiobench_tpu_torch.utils.data import biquad_lowpass_coefficients

    return np.array([biquad_lowpass_coefficients(0.25 - 0.0125 * k)
                     for k in range(SESSION_STAGES)], np.float32)


def programs(cfg: BenchConfig = BenchConfig(), headline_modes: int =
             HEADLINE_MODES, fdtd_room: Optional[int] = None
             ) -> Dict[str, Tuple[Callable, Spec]]:
    """name -> (the port function of its inputs, its spec). The headline
    modes and the FDTD room default to the JAX exporter's (1,048,576;
    room 50, a grid of ``GRID_N`` = 52 with the reference's source and
    receiver cells); the tests pass smaller ones."""
    from gpuaudiobench_tpu_torch.models.session import session_block
    from gpuaudiobench_tpu_torch.ops import fdtd3d
    from gpuaudiobench_tpu_torch.ops.conv import conv1d_direct
    from gpuaudiobench_tpu_torch.ops.elementwise import gain_op
    from gpuaudiobench_tpu_torch.ops.iir import iir_biquad
    from gpuaudiobench_tpu_torch.ops.modal import modal_bank, modal_folded_step
    from gpuaudiobench_tpu_torch.ops.partconv import partconv_block

    t, s = cfg.n_tracks, cfg.buffer_size
    room = fdtd_room or fdtd3d.ROOM
    n = fdtd3d.grid_n(room)
    cells = (fdtd3d.source_pos(room), fdtd3d.receiver_pos(room))
    bins = s + 1

    def f32(*shapes):
        return [("f32", tuple(shape)) for shape in shapes]

    def session(x, coeffs, eq_states, send, pan2, prev, fre, fim, h_re, h_im):
        return session_block(x, coeffs, eq_states, send, pan2, prev, fre, fim,
                             h_re, h_im)

    return {
        "modal_pallas": (
            lambda cw, sw, re, im: modal_folded_step(cw, sw, re, im, s,
                                                     HEADLINE_TRACKS),
            f32(*[(headline_modes,)] * 4)),
        "fdtd3d_pallas": (
            lambda x, p, d: fdtd3d.fdtd3d_block_div(x, p, d, *cells),
            f32((FDTD_TRACKS, s), (n, n, n), (n, n, n))),
        "gain": (lambda x: gain_op(x, 2.0), f32((t, s))),
        "iirfilter": (iir_biquad, f32((t, s), (5,), (t, 2))),
        "modal": (
            lambda amp, cw, sw, re, im: modal_bank(amp, cw, sw, re, im, s,
                                                   min(t, 32)),
            f32(*[(1024 * t,)] * 5)),
        "conv1d": (lambda x, ir: conv1d_direct(x, ir, "clamp"),
                   f32((t, s), (t, CONV_IR))),
        "partconv": (partconv_block,
                     f32((t, s), (t, s), *[(t, PARTITIONS, bins)] * 4)),
        # The coefficients are the module's constant (``_Program``), not a
        # spec input.
        "session": (session,
                    f32((t, s), (SESSION_STAGES, t, 2), (t,), (2, t), (2, s),
                        *[(2, PARTITIONS, bins)] * 4)),
    }


def spec_text(name: str, spec: Spec) -> str:
    """The ``.spec`` file of a program: a ``#`` line, then one
    ``<dtype> d0 d1 ...`` line an input."""
    lines = [f"# inputs for {name} (native_runner --spec)"]
    lines += [f"{dtype} {' '.join(str(d) for d in shape)}".rstrip()
              for dtype, shape in spec]
    return "\n".join(lines) + "\n"


_MUL = np.uint64(6364136223846793005)
_INC = np.uint64(1442695040888963407)
_LCG_BLOCK = 1 << 16


def _lcg_tables():
    """(a^j, c (a^(j-1) + ... + 1)) mod 2^64 for j = 1 .. _LCG_BLOCK: the
    j-th state after s is a^j s + that sum."""
    mul = np.empty(_LCG_BLOCK, np.uint64)
    add = np.empty(_LCG_BLOCK, np.uint64)
    m, a = np.uint64(1), np.uint64(0)
    with np.errstate(over="ignore"):
        for j in range(_LCG_BLOCK):
            m, a = m * _MUL, a * _MUL + _INC
            mul[j], add[j] = m, a
    return mul, add


_TABLES: list = []


def lcg_values(count: int, state: int = SEED) -> Tuple[np.ndarray, int]:
    """``count`` draws of ``NextRand`` from ``state``: (f32 values in
    [-1, 1), the state after them)."""
    if not _TABLES:
        _TABLES.append(_lcg_tables())
    mul, add = _TABLES[0]
    out = np.empty(count, np.float32)
    st = np.uint64(state)
    with np.errstate(over="ignore"):
        for lo in range(0, count, _LCG_BLOCK):
            k = min(_LCG_BLOCK, count - lo)
            states = mul[:k] * st + add[:k]
            bits = ((states >> np.uint64(33)) & np.uint64(0xFFFFFF))
            out[lo:lo + k] = (np.float32(2.0) * bits.astype(np.float32)
                              / np.float32(16777216.0) - np.float32(1.0))
            st = states[k - 1]
    return out, int(st)


def lcg_inputs(spec: Spec, device="cpu") -> List[torch.Tensor]:
    """The runner's inputs for ``spec``: one LCG from seed 42 through every
    input in order; an i32 input takes int32((v / 2 + 1 / 2) * 1000)."""
    state = SEED
    tensors = []
    for dtype, shape in spec:
        vals, state = lcg_values(int(np.prod(shape, dtype=np.int64)), state)
        if dtype == "i32":
            vals = ((vals * np.float32(0.5) + np.float32(0.5))
                    * np.float32(1000.0)).astype(np.int32)
        tensors.append(torch.from_numpy(vals.reshape(shape)).to(device))
    return tensors


def checksum(output: torch.Tensor) -> float:
    """The runner's checksum: the sum, in double, of the first 64 elements
    of output 0 in memory order."""
    flat = output.detach().reshape(-1)[:64].cpu().numpy()
    total = 0.0
    for v in flat:
        total += float(v)
    return total


def first_output(out):
    """Output 0 of a program: the first tensor of its flattened outputs."""
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


class _Program(torch.nn.Module):
    """A program as a module: ``fn`` of the inputs, and for ``session`` its
    coefficients as a buffer (a constant of the package)."""

    def __init__(self, name: str, fn: Callable, device):
        super().__init__()
        self.name = name
        self.fn = fn
        if name == "session":
            self.register_buffer("coeffs", torch.from_numpy(
                session_coefficients()).to(device))

    def forward(self, *args):
        if self.name == "session":
            args = (args[0], self.coeffs, *args[1:])
        return self.fn(*args)


def make_program(name: str, device, cfg: BenchConfig = BenchConfig(),
                 **sizes) -> Tuple[torch.nn.Module, Spec]:
    fn, spec = programs(cfg, **sizes)[name]
    return _Program(name, fn, device).to(device), spec


def compiler_has_openmp(compiler: str) -> bool:
    """Whether ``compiler`` links ``-fopenmp`` (a GCC built without libgomp
    refuses it: "cannot read spec file 'libgomp.spec'")."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "omp.cc")
        with open(src, "w") as f:
            f.write("int main() { return 0; }\n")
        proc = subprocess.run([compiler, "-fopenmp", src, "-o",
                               os.path.join(tmp, "omp")],
                              capture_output=True, text=True)
        return proc.returncode == 0


@contextlib.contextmanager
def _openmp_where_linked():
    """Inductor compiles a package's C++ with ``-fopenmp``, which needs the
    compiler's libgomp. Where the compiler it picks has none, compile
    without OpenMP: a CUDA program's C++ is its launch code, whose loops
    are Triton kernels, and a CPU program's loops then run on one
    thread."""
    from torch._inductor import cpp_builder

    if compiler_has_openmp(cpp_builder.get_cpp_compiler()):
        yield
        return
    saved = cpp_builder._get_openmp_args
    cpp_builder._get_openmp_args = lambda compiler: ([], [], [], [], [], [])
    try:
        yield
    finally:
        cpp_builder._get_openmp_args = saved


def export(name: str, out_dir: str, device="cuda",
           cfg: BenchConfig = BenchConfig(), **sizes) -> Dict[str, float]:
    """Write ``<name>.pt2`` and ``<name>.spec`` into ``out_dir``; returns
    the export and compile seconds."""
    from gpuaudiobench_tpu_torch.ops import gpuab

    gpuab.load()  # the operators must exist before the trace
    module, spec = make_program(name, device, cfg, **sizes)
    args = tuple(lcg_inputs(spec, device))
    t0 = time.perf_counter()
    ep = torch.export.export(module, args)
    t1 = time.perf_counter()
    path = os.path.join(out_dir, f"{name}.pt2")
    with _openmp_where_linked():
        torch._inductor.aoti_compile_and_package(ep, package_path=path)
    t2 = time.perf_counter()
    with open(os.path.join(out_dir, f"{name}.spec"), "w") as f:
        f.write(spec_text(name, spec))
    return {"export_s": t1 - t0, "compile_s": t2 - t1}


def main(argv: Optional[Sequence[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=".")
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    ap.add_argument("names", nargs="*")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.names) - set(NAMES))
    if unknown:
        print(f"unknown program(s): {', '.join(unknown)}; names: "
              f"{' '.join(NAMES)}", file=sys.stderr)
        return 1
    if args.device == "cuda" and not torch.cuda.is_available():
        print("CUDA requested but torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    for name in args.names or NAMES:
        t = export(name, args.out, args.device)
        print(f"exported {name}: {os.path.join(args.out, name)}.pt2 "
              f"(export {t['export_s']:.2f} s, compile {t['compile_s']:.2f} "
              f"s), {name}.spec", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
