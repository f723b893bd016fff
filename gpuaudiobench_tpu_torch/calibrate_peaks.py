"""Measure the roofline denominators on the card and write them down.

    python -m gpuaudiobench_tpu_torch.calibrate_peaks [--nRuns 10]
        [--warmup 2] [--pipelineDepth 256] [--out PATH] [--dry]
        [--only SOL_MXU_bf16 ...]

PyTorch counterpart of ``tools/calibrate_peaks.py``. Runs the six
speed-of-light benchmarks (``models/speedoflight.py``) through the
port's harness on the CUDA device and writes their achieved rates, which
by construction are the card's peaks, to
``gpuaudiobench_tpu_torch/utils/measured_peaks.json`` (or ``--out``),
under the card's ``torch.cuda.get_device_name()``, with its power limit
and maximum SM clock from nvidia-smi beside it. ``utils/roofline.py``
reads the file for every later %-of-peak on a card of that name.

Sizes: the benchmarks' defaults, except where a block's fixed cost
would bias the rate. SOL_VPU and SOL_VMEM run k = 4,096 passes (at the
default 512, SOL_VPU's 8 MiB are loaded before the first FMA and stored
after the last in one wave, a fifth of its 0.04 ms block on an H100), and
SOL_HBM streams 1,024 MiB (its default 64 MiB block of 0.05 ms carries a
fixed cost of the launch and the grid's ramp, so cuFFT's FFT1D pass over
128 MiB reads above its rate). The payload records the sizes used.

Rate basis: the device tier's median (CUDA events behind a spin: the
device's own time of one block), else the saturated per-block median,
which still carries a share of the host's launch cost and so gives a
lower rate: a denominator that errs low, never high.

It refuses to run without a CUDA device (a CPU rate is no peak of the
card), and refuses a SOL_VMEM row that did not run the shared-memory
kernel.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
from typing import Dict, Optional

import torch

from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.utils.roofline import (
    MEASURED_PEAKS_PATH,
    SPEC_PEAK,
)

# SOL benchmark -> the peak key its achieved rate calibrates, and the
# cost_model() quantity the rate is taken from.
TARGETS = {
    "SOL_VPU": ("vpu_f32_flops", "flops"),
    "SOL_VMEM": ("vmem_bytes_per_sec", "vmem_bytes"),
    "SOL_HBM": ("hbm_bytes_per_sec", "hbm_bytes"),
    "SOL_MXU_bf16": ("mxu_bf16_flops", "flops"),
    "SOL_MXU_f32": ("mxu_f32_flops", "flops"),
    "SOL_MXU_int8": ("mxu_int8_flops", "flops"),
}


# The two sizes the calibration takes beyond the benchmarks' defaults (see
# the module docstring).
CALIBRATION_FMA_K = 4096
CALIBRATION_STREAM_MIB = 1024


def card_clocks() -> Dict[str, Optional[str]]:
    """The card's power limit and maximum SM clock as nvidia-smi prints
    them (None where nvidia-smi is missing or fails)."""
    from gpuaudiobench_tpu_torch.utils.device import nvidia_smi

    fields = (nvidia_smi("power.limit,clocks.max.sm") or "").split(",")
    if len(fields) != 2:
        return {"power_limit": None, "clocks_max_sm": None}
    return {"power_limit": fields[0].strip(),
            "clocks_max_sm": fields[1].strip()}


def measure(cfg: BenchConfig, name: str, device: torch.device) -> dict:
    """Run one SOL benchmark and return its calibration row; raises
    RuntimeError when it fails validation, has no timing basis, or is a
    SOL_VMEM run of the plain twin."""
    from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
    from gpuaudiobench_tpu_torch.registry import create_benchmark

    bench = create_benchmark(name, cfg, device)
    bench.setup()
    meta = bench.metadata()
    if name == "SOL_VMEM" and meta.get("impl") != "cuda-kernel":
        # The twin computes the same values with the carry in registers
        # and caches: its rate is no shared-memory rate.
        raise RuntimeError(
            f"SOL_VMEM ran the plain twin (impl={meta.get('impl')!r}); a "
            "shared-memory peak is calibrated from the fma_vmem kernel only")
    result = run_benchmark(bench, cfg, verbose=False)
    if result.validation is None or not result.validation.passed:
        raise RuntimeError(
            f"{name} failed validation: "
            f"{(result.validation.messages if result.validation else [])[:3]}")
    cost = bench.cost_model()
    row = {
        "benchmark": name,
        "metadata": meta,
        "cost": cost,
        "device_ms": (result.device_statistics.median
                      if result.device_statistics is not None else None),
        "device_timing_method": result.device_timing_method,
        "saturated_p50_ms": (result.saturated_statistics.median
                             if result.saturated_statistics is not None
                             else None),
    }
    basis_ms, basis = None, None
    if row["device_ms"] and result.device_timing_method == "cuda-events":
        basis_ms, basis = row["device_ms"], "cuda-events"
    elif row["saturated_p50_ms"]:
        basis_ms, basis = row["saturated_p50_ms"], "saturated"
    if basis_ms is None or basis_ms <= 0:
        raise RuntimeError(f"{name}: no usable timing basis")
    key, quantity = TARGETS[name]
    rate = float(cost[quantity]) / (basis_ms / 1e3)
    row.update({"basis": basis, "basis_ms": basis_ms, "peak_key": key,
                "measured_rate": rate})
    bench.cleanup()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nRuns", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--pipelineDepth", type=int, default=256)
    ap.add_argument("--out", default=MEASURED_PEAKS_PATH)
    ap.add_argument("--dry", action="store_true",
                    help="print, do not write the json")
    ap.add_argument("--only", nargs="+", choices=list(TARGETS),
                    help="measure these benchmarks only; the other peaks "
                         "are kept from --out (or the shipped file)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("calibrate_peaks: no CUDA device; the peaks are the card's "
              "and are measured on it only", file=sys.stderr)
        return 1
    from gpuaudiobench_tpu_torch.utils import device as dev

    device = dev.device("cuda")
    cfg = BenchConfig(
        n_runs=args.nRuns, warmup=args.warmup,
        pipeline_depth=args.pipelineDepth, verification="spot",
        sol_fma_k=CALIBRATION_FMA_K, sol_stream_mib=CALIBRATION_STREAM_MIB,
        # The basis is the device tier; the marginal tier's second chain
        # would only slow the calibration down.
        saturated_marginal=False,
    )
    kind = torch.cuda.get_device_name(device)
    clocks = card_clocks()
    print(f"Calibrating peaks on: {kind}, power limit "
          f"{clocks['power_limit']}, max SM clock {clocks['clocks_max_sm']}")

    rows, peaks = [], {}
    if args.only:
        base = args.out if os.path.exists(args.out) else MEASURED_PEAKS_PATH
        with open(base) as f:
            kept = json.load(f)
        peaks = dict(kept["peaks"])
        rows = kept["raw"]
    for name in args.only or TARGETS:
        print(f"  {name} ...", flush=True)
        row = measure(cfg, name, device)
        rows = [r for r in rows if r["benchmark"] != name]
        rows.insert(list(TARGETS).index(name), row)
        peaks[row["peak_key"]] = row["measured_rate"]
        unit = ("GB/s" if row["peak_key"].endswith("bytes_per_sec")
                else "GFLOP/s")
        print(f"    {row['measured_rate'] / 1e9:,.1f} {unit} "
              f"[{row['basis']} {row['basis_ms']:.4f} ms] "
              f"(data sheet {SPEC_PEAK[row['peak_key']] / 1e9:,.1f})")

    payload = {
        "device_kind": kind,
        "platform": "gpu",
        "power_limit": clocks["power_limit"],
        "clocks_max_sm": clocks["clocks_max_sm"],
        "measured_at": datetime.date.today().isoformat(),
        "config": {
            "nRuns": args.nRuns, "pipelineDepth": args.pipelineDepth,
            "solFmaK": cfg.sol_fma_k, "solFmaMiB": cfg.sol_fma_mib,
            "solVmemMiB": cfg.sol_vmem_mib,
            "solStreamMiB": cfg.sol_stream_mib,
            "solMatmulDim": cfg.sol_matmul_dim,
        },
        "peaks": peaks,
        "raw": rows,
    }
    if args.dry:
        print(json.dumps(payload, indent=2))
        return 0
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    print(f"Wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
