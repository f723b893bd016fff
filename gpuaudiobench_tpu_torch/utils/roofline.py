"""Roofline accounting against the card's measured peaks.

PyTorch counterpart of ``gpuaudiobench_tpu/utils/roofline.py``, with the
same keys, functions and output, so that JSON readers of both packages
read one schema. Each benchmark declares an algorithmic cost per block
(``cost_model()``: FLOPs, minimum device-memory bytes, optionally
shared-memory bytes, and which unit does the work); divided by the
measured device time of a block it gives achieved rates and their share
of the card's peaks.

The peaks come from the speed-of-light benchmarks
(``models/speedoflight.py``), run on the card by
``python -m gpuaudiobench_tpu_torch.calibrate_peaks``, which writes
``measured_peaks.json`` beside this module under the card's
``torch.cuda.get_device_name()``. ``SPEC_PEAK`` is only the fallback
where no calibration of the running card's kind exists. What each key
means on Hopper:

* ``vpu_f32_flops``      -- FP32 FMA on the CUDA cores;
* ``vmem_bytes_per_sec`` -- the shared-memory pass rate (a load and a
                            store of the carried state);
* ``hbm_bytes_per_sec``  -- HBM3;
* ``mxu_bf16_flops``     -- tensor-core bf16, dense;
* ``mxu_int8_flops``     -- tensor-core int8, dense;
* ``mxu_f32_flops``      -- the delivered f32 GEMM rate (full FP32, TF32
                            off: the CUDA cores' FMA rate).

Every roofline dict carries ``peak_source`` ("measured(<card>, <date>)",
with "+spec:<keys>" for keys a partial calibration lacks, or
"spec-estimate").
"""

from __future__ import annotations

import functools
import json
import os
from typing import Any, Dict, Optional, Tuple

# NVIDIA H100 SXM data sheet at its full 700 W power limit (dense rates).
# No data sheet gives the shared-memory rate: 132 SMs x 128 B a clock x
# 1.98 GHz is an estimate.
SPEC_PEAK = {
    "mxu_bf16_flops": 989e12,
    "mxu_f32_flops": 67e12,
    "mxu_int8_flops": 1979e12,
    "vpu_f32_flops": 67e12,
    "hbm_bytes_per_sec": 3.35e12,
    "vmem_bytes_per_sec": 132 * 128 * 1.98e9,
}

UNIT_PEAK_KEY = {
    "mxu": "mxu_f32_flops",
    "mxu_bf16": "mxu_bf16_flops",
    "mxu_int8": "mxu_int8_flops",
    "vpu": "vpu_f32_flops",
}

MEASURED_PEAKS_PATH = os.path.join(
    os.path.dirname(__file__), "measured_peaks.json"
)

# Below this share of EVERY modeled wall a workload is not "X-bound": the
# time goes to something the roofline does not model (launch latency, a
# serial recurrence), and the bound label says "latency".
LATENCY_BOUND_THRESHOLD_PCT = 20.0


@functools.lru_cache(maxsize=None)
def _load_measured(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data.get("peaks"), dict):
            return None
        return data
    except (OSError, json.JSONDecodeError):
        return None


def resolve_peaks(
    device_kind: Optional[str] = None, path: Optional[str] = None
) -> Tuple[Dict[str, float], str]:
    """(peaks, source) for the given device kind.

    The calibrated file is used only when it exists and its device_kind
    equals the requested one; otherwise the data-sheet values. A None
    device_kind does not accept the calibration: another card's measured
    peaks are wronger than a labelled data-sheet value. Calibrated values
    override the data sheet key by key, and the keys a partial
    calibration lacks are named in the source.
    """
    measured = _load_measured(path or MEASURED_PEAKS_PATH)
    if measured is not None and device_kind is not None:
        kind = measured.get("device_kind")
        if kind == device_kind:
            peaks = dict(SPEC_PEAK)
            peaks.update(
                {k: float(v) for k, v in measured["peaks"].items()
                 if k in SPEC_PEAK}
            )
            stamp = measured.get("measured_at", "")
            source = (
                f"measured({kind or 'unknown'}"
                f"{', ' + stamp if stamp else ''})"
            )
            missing = sorted(k for k in SPEC_PEAK
                             if k not in measured["peaks"])
            if missing:
                source += " +spec:" + ",".join(missing)
            return peaks, source
    return dict(SPEC_PEAK), "spec-estimate"


def roofline_metrics(
    cost: Dict[str, Any],
    device_ms: float,
    device_kind: Optional[str] = None,
) -> Optional[Dict[str, Any]]:
    """Achieved rates against the peaks for one block.

    ``cost``: {"flops", "hbm_bytes", optional "vmem_bytes", "unit",
    optional "note"}. ``device_ms``: the measured device time of a block.
    ``device_kind``: ``torch.cuda.get_device_name()`` of the card that
    ran it, which selects the calibration.
    """
    if device_ms <= 0:
        return None
    peaks, source = resolve_peaks(device_kind)
    sec = device_ms / 1e3
    flops = float(cost.get("flops", 0))
    hbm_bytes = float(cost.get("hbm_bytes", 0))
    unit = cost.get("unit", "vpu")
    out: Dict[str, Any] = {
        "device_ms": device_ms,
        "flops_per_block": flops,
        "hbm_bytes_per_block": hbm_bytes,
        "achieved_gflops": flops / sec / 1e9,
        "achieved_gbps": hbm_bytes / sec / 1e9,
        "hbm_pct_of_peak": 100.0 * (hbm_bytes / sec) / peaks["hbm_bytes_per_sec"],
        "unit": unit,
        "peak_source": source,
    }
    vmem_bytes = float(cost.get("vmem_bytes", 0))
    if vmem_bytes > 0:
        out["vmem_bytes_per_block"] = vmem_bytes
        out["achieved_vmem_gbps"] = vmem_bytes / sec / 1e9
        out["vmem_pct_of_peak"] = (
            100.0 * (vmem_bytes / sec) / peaks["vmem_bytes_per_sec"]
        )
    peak_key = UNIT_PEAK_KEY.get(unit)
    walls = {"bandwidth": out["hbm_pct_of_peak"]}
    if vmem_bytes > 0:
        walls["vmem"] = out["vmem_pct_of_peak"]
    if peak_key and flops > 0:
        out["flops_pct_of_peak"] = 100.0 * (flops / sec) / peaks[peak_key]
        walls["compute"] = out["flops_pct_of_peak"]
    # The nearest wall names the bound only when the block comes near it.
    nearest = max(walls, key=walls.get)
    out["nearest_wall"] = nearest
    out["nearest_wall_pct"] = walls[nearest]
    out["bound"] = (
        nearest if walls[nearest] >= LATENCY_BOUND_THRESHOLD_PCT
        else "latency"
    )
    if "note" in cost:
        out["note"] = cost["note"]
    return out
