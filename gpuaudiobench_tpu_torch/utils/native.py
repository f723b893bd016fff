"""ctypes binding of the native harness core (``native/gpuab_native.cc``).

PyTorch-package counterpart of ``gpuaudiobench_tpu/utils/native.py``.
The C++ source is the suite's own, used as it is; the port binds its
statistics and its DAW-load pacer. It is built with

    g++ -O2 -std=c++17 -fPIC -shared -o build/torch_kernels/gpuab_native-<hash>.so \\
        native/gpuab_native.cc

at first use, into the kernels' build directory (``utils/build.py``); the
file name carries a hash of the source and the flags, so an edited source
never loads a stale library. ``make_dawsim`` takes the native pacer and
falls back to the Python one (``harness/dawsim.py``) where the build or
the load fails; the pacer in use names itself in ``pacer``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

from gpuaudiobench_tpu_torch.harness.statistics import LatencyStats
from gpuaudiobench_tpu_torch.utils.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "gpuab_native.cc"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")


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


def build() -> Path:
    """Compile the source unless its keyed library exists. Raises
    ``RuntimeError`` when there is no g++, no source, or the build fails."""
    if not SOURCE.is_file():
        raise RuntimeError(f"native source not found: {SOURCE}")
    lib = library_path()
    if lib.is_file():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build to a temporary name and rename, so a concurrent or cut-off
    # build never leaves a half-written library under the final name.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


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
