"""ctypes binding of the native harness core (``csrc/gpuab_native.cc``)
and the native command-line driver (``csrc/gpubench_main.cc``).

PyTorch-package counterpart of ``gpuaudiobench_tpu/utils/native.py``.
The harness core's C++ source is the suite's own (``native/gpuab_native.cc``),
kept byte for byte as the package's copy, so an installed port builds it
from its own files; the port binds its statistics and its DAW-load
pacer. It is built with

    g++ -O2 -std=c++17 -fPIC -shared -o build/torch_kernels/gpuab_native-<hash>.so \\
        gpuaudiobench_tpu_torch/csrc/gpuab_native.cc

at first use, into the kernels' build directory (``utils/build.py``); the
file name carries a hash of the source and the flags, so an edited source
never loads a stale library. ``make_dawsim`` takes the native pacer and
falls back to the Python one (``harness/dawsim.py``) where the build or
the load fails; the pacer in use names itself in ``pacer``.

``build_driver`` builds the native driver, an executable that embeds
the interpreter running this module (``sys.executable``) and forwards
its argv to ``gpuaudiobench_tpu_torch.cli.main``:

    python -m gpuaudiobench_tpu_torch.utils.native   # builds, prints the paths

(the driver, the native runner and the ``gpuab`` operator library, below).

It compiles with g++ and the ``python3-config --includes`` and
``--ldflags --embed`` of that interpreter's installation into
``build/torch_kernels/gpubench-<hash>``; a failed build raises (there is
no fallback to ``python -m``).

``build_ops`` builds the ``gpuab`` operator library (``csrc/torch_ops.cc``)
and ``build_runner`` the native runner (``csrc/native_runner.cc``), which
loads an AOTInductor package and runs it with no interpreter in the
process. Both compile with g++ against PyTorch's headers
(``torch.utils.cpp_extension.include_paths()``) and link its libraries
(``library_paths()``, with an rpath), never libpython. Where this PyTorch
is built for CUDA they define ``GPUAB_WITH_CUDA``: the library then holds
the CUDA implementations and links the kernels' libraries
(``utils/build.py``), and the runner links ``torch_cuda``. Elsewhere the
library holds the operators' schemas alone and the runner runs on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
from pathlib import Path
from typing import Optional, Sequence

from gpuaudiobench_tpu_torch.harness.statistics import LatencyStats
from gpuaudiobench_tpu_torch.utils.build import BUILD_DIR

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCE = CSRC / "gpuab_native.cc"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
DRIVER_SOURCE = CSRC / "gpubench_main.cc"
DRIVER_CXX_FLAGS = ("-O2", "-std=c++17")
# The directory holding the package: the driver puts it first on sys.path.
PACKAGE_ROOT = Path(__file__).resolve().parents[2]
OPS_SOURCE = CSRC / "torch_ops.cc"
RUNNER_SOURCE = CSRC / "native_runner.cc"
# The kernel sources whose C entries the operator library calls: all of
# them.
OPS_KERNELS = ("modal_bank", "iir", "conv1d", "rndmem", "dwg", "fdtd3d",
               "speedoflight")
# PyTorch's headers warn under C++17; its own extensions build as C++20.
TORCH_CXX_FLAGS = ("-O2", "-std=c++20", "-fPIC")


class _GpuabStats(ctypes.Structure):
    _fields_ = [
        ("mean", ctypes.c_double),
        ("median", ctypes.c_double),
        ("std_dev", ctypes.c_double),
        ("min_val", ctypes.c_double),
        ("max_val", ctypes.c_double),
        ("p95", ctypes.c_double),
        ("p99", ctypes.c_double),
        ("count", ctypes.c_int64),
    ]


def library_path() -> Path:
    """Where the source builds to: keyed on the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"gpuab_native-{h.hexdigest()[:16]}.so"


def _compile(source: Path, out: Path, before: Sequence[str],
             after: Sequence[str] = ()) -> Path:
    """``g++ <before> -o <out> <source> <after>`` unless ``out`` exists.
    Raises ``RuntimeError`` when there is no g++, no source, or the build
    fails."""
    if not source.is_file():
        raise RuntimeError(f"native source not found: {source}")
    if out.is_file():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build to a temporary name and rename, so a concurrent or cut-off
    # build never leaves a half-written file under the final name.
    fd, tmp = tempfile.mkstemp(suffix=out.suffix, dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *before, "-o", tmp, str(source), *after],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build() -> Path:
    """Compile the source unless its keyed library exists. Raises
    ``RuntimeError`` when there is no g++, no source, or the build fails."""
    return _compile(SOURCE, library_path(), CXX_FLAGS)


def python_config() -> str:
    """The ``python3-config`` of the running interpreter's installation
    (its ``BINDIR``: the base installation's, under a virtual
    environment). Raises ``RuntimeError`` where there is none."""
    bindir = Path(sysconfig.get_config_var("BINDIR") or "")
    version = sysconfig.get_config_var("VERSION") or ""
    for name in (f"python{version}-config", "python3-config"):
        if (bindir / name).is_file():
            return str(bindir / name)
    raise RuntimeError(f"no python{version}-config or python3-config in "
                       f"{bindir}: the driver needs the interpreter's "
                       "development files")


def _c_string(text: str) -> str:
    return '"' + text.replace("\\", "\\\\").replace('"', '\\"') + '"'


@functools.lru_cache(maxsize=None)
def driver_flags() -> tuple:
    """(compile flags, link flags) of the driver: ``python3-config
    --includes``, the interpreter and the package root as defines, and
    ``--ldflags --embed`` with an rpath to the library directory and the
    interpreter's ``LINKFORSHARED`` (extension modules resolve CPython's
    symbols in the executable)."""
    cfg = python_config()

    def query(*args):
        proc = subprocess.run([cfg, *args], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cfg} {' '.join(args)} failed "
                               f"({proc.returncode}): {proc.stderr}")
        return proc.stdout.split()

    compile_flags = (*DRIVER_CXX_FLAGS, *query("--includes"),
                     f"-DGPUBENCH_PYTHON={_c_string(sys.executable)}",
                     f"-DGPUBENCH_ROOT={_c_string(str(PACKAGE_ROOT))}")
    link = query("--ldflags", "--embed")
    libdir = sysconfig.get_config_var("LIBDIR")
    if libdir:
        link.append(f"-Wl,-rpath,{libdir}")
    link += (sysconfig.get_config_var("LINKFORSHARED") or "").split()
    return compile_flags, tuple(link)


def driver_path() -> Path:
    """Where the driver builds to: keyed on its source and its flags."""
    compile_flags, link = driver_flags()
    h = hashlib.sha256(DRIVER_SOURCE.read_bytes())
    h.update(" ".join(compile_flags + link).encode())
    return BUILD_DIR / f"gpubench-{h.hexdigest()[:16]}"


def build_driver() -> Path:
    """Compile the native driver unless its keyed executable exists; its
    path. Raises ``RuntimeError`` where it cannot."""
    compile_flags, link = driver_flags()
    return _compile(DRIVER_SOURCE, driver_path(), compile_flags, link)


def _key(name: str, suffix: str, *parts) -> Path:
    """``BUILD_DIR/<name>-<hash><suffix>``, the hash over ``parts`` (bytes
    or text)."""
    h = hashlib.sha256()
    for part in parts:
        h.update(part if isinstance(part, bytes) else str(part).encode())
        h.update(b"\0")
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}{suffix}"


def with_cuda() -> bool:
    """Whether the operator library and the runner are built with their
    CUDA parts: where this PyTorch is built for CUDA."""
    import torch

    return torch.version.cuda is not None


@functools.lru_cache(maxsize=None)
def torch_flags(cuda: bool) -> tuple:
    """(compile flags, link flags) against this PyTorch: its headers, the
    C++ ABI it was built with, its libraries with an rpath; with ``cuda``
    the toolkit's headers (beside nvcc), ``GPUAB_WITH_CUDA`` and the CUDA
    libraries."""
    import torch
    from torch.utils import cpp_extension

    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    compile_flags = [*TORCH_CXX_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={abi}"]
    compile_flags += [f"-I{p}" for p in cpp_extension.include_paths()]
    link = []
    for p in cpp_extension.library_paths():
        link += [f"-L{p}", f"-Wl,-rpath,{p}"]
    link += ["-Wl,--no-as-needed", "-ltorch", "-ltorch_cpu", "-lc10"]
    if cuda:
        from gpuaudiobench_tpu_torch.utils.build import nvcc_path

        cuda_home = Path(nvcc_path()).resolve().parents[1]
        compile_flags += ["-DGPUAB_WITH_CUDA", f"-I{cuda_home / 'include'}"]
        link += ["-ltorch_cuda", "-lc10_cuda"]
    return tuple(compile_flags), tuple(link)


def ops_object_path(cuda: bool) -> Path:
    compile_flags, _ = torch_flags(cuda)
    return _key("gpuab_ops", ".o", OPS_SOURCE.read_bytes(), *compile_flags)


def compile_ops(cuda: Optional[bool] = None) -> Path:
    """Compile ``csrc/torch_ops.cc`` to an object (the slow part of
    ``build_ops``: it needs no kernel library, so it can run beside nvcc)."""
    cuda = with_cuda() if cuda is None else cuda
    compile_flags, _ = torch_flags(cuda)
    return _compile(OPS_SOURCE, ops_object_path(cuda), ["-c", *compile_flags])


def build_ops(cuda: Optional[bool] = None) -> Path:
    """The ``gpuab`` operator library: ``compile_ops``, then a link against
    PyTorch and, with CUDA, the kernels' libraries (built first, by name
    through an rpath to the build directory); keyed on the object and the
    libraries, so a rebuilt kernel relinks it. Raises ``RuntimeError``
    where it cannot."""
    from gpuaudiobench_tpu_torch.utils import build as kernels

    cuda = with_cuda() if cuda is None else cuda
    obj = compile_ops(cuda)
    _, link = torch_flags(cuda)
    link = list(link)
    if cuda:
        libs = kernels.build_all(list(OPS_KERNELS))
        link[:0] = [f"-L{BUILD_DIR}", f"-Wl,-rpath,{BUILD_DIR}",
                    *(f"-l:{lib.name}" for lib in libs)]
    out = _key("gpuab_ops", ".so", obj.name, *link)
    return _compile(obj, out, ["-shared"], link)


def runner_path(cuda: Optional[bool] = None) -> Path:
    """Where the runner builds to: keyed on its source and its flags."""
    cuda = with_cuda() if cuda is None else cuda
    compile_flags, link = torch_flags(cuda)
    return _key("native_runner", "", RUNNER_SOURCE.read_bytes(),
                *compile_flags, *link)


def build_runner(cuda: Optional[bool] = None) -> Path:
    """Compile the native runner unless its keyed executable exists; its
    path. It links libtorch (and its CUDA libraries with ``cuda``) and
    ``-ldl``, no libpython. Raises ``RuntimeError`` where it cannot."""
    cuda = with_cuda() if cuda is None else cuda
    compile_flags, link = torch_flags(cuda)
    return _compile(RUNNER_SOURCE, runner_path(cuda), compile_flags,
                    [*link, "-ldl"])


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, once a process. Raises
    ``RuntimeError`` or ``OSError`` where it cannot."""
    lib = ctypes.CDLL(str(build()))
    lib.gpuab_calculate_statistics.restype = ctypes.c_int
    lib.gpuab_calculate_statistics.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(_GpuabStats)]
    lib.gpuab_dawsim_create.restype = ctypes.c_void_p
    lib.gpuab_dawsim_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_uint32]
    for name in ("gpuab_dawsim_destroy", "gpuab_dawsim_reset",
                 "gpuab_dawsim_wait"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p]
    return lib


def calculate_statistics_native(latencies: Sequence[float]) -> LatencyStats:
    """``harness.statistics.calculate_statistics`` computed by the
    library. Raises ``ValueError`` where it refuses the input."""
    lib = load()
    n = len(latencies)
    arr = (ctypes.c_double * n)(*latencies)
    out = _GpuabStats()
    if lib.gpuab_calculate_statistics(arr, n, ctypes.byref(out)) != 0:
        raise ValueError(f"gpuab_calculate_statistics refused {n} values")
    return LatencyStats(
        mean=out.mean, median=out.median, std_dev=out.std_dev,
        min_val=out.min_val, max_val=out.max_val,
        p95=out.p95, p99=out.p99, count=int(out.count),
    )


class NativeDAWSimulator:
    """The C++ spin/sleep pacer (drop-in for ``harness.dawsim.DAWSimulator``).
    Its jitter draws come from std::mt19937, not Python's generator."""

    pacer = "native"

    def __init__(self, buffer_size: int, fs: int, mode: str = "spin",
                 jitter_us: float = 0.0, seed: int = 42):
        if mode not in ("spin", "sleep"):
            raise ValueError(f"invalid dawsim mode: {mode}")
        self._lib = load()
        self.mode = mode
        self._handle = self._lib.gpuab_dawsim_create(
            buffer_size, fs, 1 if mode == "sleep" else 0, float(jitter_us),
            seed & 0xFFFFFFFF)

    def reset(self) -> None:
        self._lib.gpuab_dawsim_reset(self._handle)

    def wait(self) -> None:
        self._lib.gpuab_dawsim_wait(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.gpuab_dawsim_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()


def make_dawsim(buffer_size: int, fs: int, mode: str, jitter_us: float,
                seed: int):
    """The native pacer where the library builds and loads, else the
    Python one."""
    try:
        return NativeDAWSimulator(buffer_size, fs, mode, jitter_us, seed)
    except (RuntimeError, OSError):
        from gpuaudiobench_tpu_torch.harness.dawsim import DAWSimulator

        return DAWSimulator(buffer_size, fs, mode, jitter_us, seed)


def main() -> int:
    print(build_driver())
    print(build_runner())
    print(build_ops())
    return 0


if __name__ == "__main__":
    sys.exit(main())
