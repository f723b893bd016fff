"""Golden-case validation: the absolute-, relative- and complex-error
checks.

A copy of ``compare_abs``, ``compare_rel``, ``compare_complex`` and
``ValidationData`` (with ``merge_failure``) from
``gpuaudiobench_tpu/harness/validation.py`` (the reference's
cuda/bench_base.cu:181-225, GPUABenchmark.swift:527-601,
cuda/bench_conv1d_accel.cu:310-330 and cuda/bench_fft.cu:79-88), so the
port never imports the reference package; ``tests/test_torch_harness.py``,
``tests/test_torch_iir_bench.py`` and ``tests/test_torch_conv.py`` hold
each copy equal. Verification modes
full / spot / none; spot = a strided sample of <= limit indices plus the
final element.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np


class ValidationStatus(enum.Enum):
    SUCCESS = "SUCCESS"
    FAILURE = "FAILURE"
    FATAL = "FATAL"
    SKIPPED = "SKIPPED"


@dataclasses.dataclass
class ValidationData:
    status: ValidationStatus = ValidationStatus.SUCCESS
    max_error: float = 0.0
    mean_error: float = 0.0
    error_count: int = 0
    samples_checked: int = 0
    messages: List[str] = dataclasses.field(default_factory=list)

    def merge_failure(self, other: "ValidationData") -> None:
        """Fold a secondary check (a filter state) into this one."""
        self.max_error = max(self.max_error, other.max_error)
        self.samples_checked += other.samples_checked
        self.error_count += other.error_count
        if other.status == ValidationStatus.FAILURE:
            self.status = ValidationStatus.FAILURE
        self.messages.extend(other.messages)

    @property
    def passed(self) -> bool:
        return self.status in (ValidationStatus.SUCCESS, ValidationStatus.SKIPPED)


def spot_indices(total: int, limit: int) -> np.ndarray:
    """Strided spot-check indices: <=limit samples plus the last element."""
    if total <= limit:
        return np.arange(total)
    stride = total // limit
    idx = np.arange(0, total, stride)[:limit]
    if idx[-1] != total - 1:
        idx = np.append(idx, total - 1)
    return idx


def _select(out: np.ndarray, ref: np.ndarray, mode: str,
            limit: int) -> Optional[tuple]:
    out = np.asarray(out).ravel()
    ref = np.asarray(ref).ravel()
    if out.shape != ref.shape:
        return None
    if mode == "spot":
        idx = spot_indices(out.size, limit)
        return out[idx], ref[idx]
    return out, ref


def _finish(v: ValidationData, err: np.ndarray, tolerance: float,
            label: str) -> ValidationData:
    v.samples_checked = int(err.size)
    v.max_error = float(err.max()) if err.size else 0.0
    v.mean_error = float(err.mean()) if err.size else 0.0
    over = err > tolerance
    v.error_count = int(over.sum())
    if v.error_count > 0:
        v.status = ValidationStatus.FAILURE
        # Per-element messages capped at 10 (bench_base.cu:204).
        for i in np.flatnonzero(over)[:10]:
            v.messages.append(
                f"{label}: error at index {int(i)}: diff {float(err[i]):.6g}")
        v.messages.insert(
            0,
            f"{label}: {v.error_count} of {v.samples_checked} elements "
            f"exceeded tolerance {tolerance:g}",
        )
    return v


def compare_abs(
    out: np.ndarray,
    ref: np.ndarray,
    tolerance: float,
    mode: str = "full",
    limit: int = 1024,
    label: str = "validation",
) -> ValidationData:
    """Absolute-error comparison (cuda/bench_base.cu:181-225)."""
    v = ValidationData()
    if mode == "none":
        v.status = ValidationStatus.SKIPPED
        return v
    sel = _select(out, ref, mode, limit)
    if sel is None:
        v.status = ValidationStatus.FATAL
        v.messages.append(
            f"{label}: shape mismatch {np.shape(out)} vs {np.shape(ref)}")
        return v
    o, r = sel
    err = np.abs(o.astype(np.float64) - r.astype(np.float64))
    return _finish(v, err, tolerance, label)


def compare_rel(
    out: np.ndarray,
    ref: np.ndarray,
    tolerance: float,
    mode: str = "full",
    limit: int = 1024,
    label: str = "validation",
    floor: float = 0.0,
) -> ValidationData:
    """Relative-error comparison; absolute where ref == 0. ``floor`` > 0
    divides by max(|ref|, floor): with floor = max|golden| the check is
    relative to the golden's peak."""
    v = ValidationData()
    if mode == "none":
        v.status = ValidationStatus.SKIPPED
        return v
    sel = _select(out, ref, mode, limit)
    if sel is None:
        v.status = ValidationStatus.FATAL
        v.messages.append(
            f"{label}: shape mismatch {np.shape(out)} vs {np.shape(ref)}")
        return v
    o, r = sel
    o64 = o.astype(np.float64)
    r64 = r.astype(np.float64)
    absdiff = np.abs(o64 - r64)
    denom = np.maximum(np.abs(r64), floor)
    err = np.where(denom != 0.0,
                   absdiff / np.where(denom == 0.0, 1.0, denom), absdiff)
    return _finish(v, err, tolerance, label)


def compare_complex(
    out_re: np.ndarray,
    out_im: np.ndarray,
    ref_re: np.ndarray,
    ref_im: np.ndarray,
    tolerance: float,
    mode: str = "full",
    limit: int = 1024,
    label: str = "validation",
) -> ValidationData:
    """Complex comparison with |d_re|+|d_im| error (cuda/bench_fft.cu:79-88)."""
    v = ValidationData()
    if mode == "none":
        v.status = ValidationStatus.SKIPPED
        return v
    err_full = np.abs(
        np.asarray(out_re, dtype=np.float64).ravel()
        - np.asarray(ref_re, dtype=np.float64).ravel()
    ) + np.abs(
        np.asarray(out_im, dtype=np.float64).ravel()
        - np.asarray(ref_im, dtype=np.float64).ravel()
    )
    if mode == "spot":
        err_full = err_full[spot_indices(err_full.size, limit)]
    return _finish(v, err_full, tolerance, label)
