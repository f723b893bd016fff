"""Headline benchmark on the GPU: modal synthesis, 1M modes, 512-sample
blocks.

Runs the suite's flagship workload (1,048,576-mode modal synthesis into
a 512-sample buffer, folded onto 32 output tracks) through the PyTorch
port and prints ONE JSON line with the same keys as the root
``bench.py``:

  {"metric": "modal_1M_block_ms", "value": <ms/block at saturation>,
   "unit": "ms", "vs_baseline": <RTX4070_p50 / value>, ...,
   "backend": "torch-cuda", "device_name": ..., "power_limit": ...,
   "kernel_launches": N}

value = saturated rep-median ms/block (pipeline_depth chained blocks
between two host synchronisations); vs_baseline > 1 means faster than
the reference's PC platform (i7-12700 + RTX 4070, p50 = 3.168 ms,
BASELINE.md tab4 "Modal, 1,000,000 modes"). kernel_launches counts the
launches of the hand-written CUDA kernel during this run.

Usage: python -m gpuaudiobench_tpu_torch.bench
"""

from __future__ import annotations

import json
import sys

BASELINE_PC_P50_MS = 3.168  # BASELINE.md: Modal 1M modes, RTX 4070 p50
PIPELINE_DEPTH = 512
METRIC = "modal_1M_block_ms"


def main(n_tracks: int = 1024, n_runs: int = 30, warmup: int = 5,
         pipeline_depth: int = PIPELINE_DEPTH, device: str = "cuda") -> int:
    # Keyword knobs exist so tests can run the same code path at toy
    # sizes on the CPU; the defaults are the headline configuration.
    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
    from gpuaudiobench_tpu_torch.ops import modal as modal_ops
    from gpuaudiobench_tpu_torch.registry import create_benchmark
    from gpuaudiobench_tpu_torch.utils import device as dev

    torch_dev = dev.device(device)
    identity = dev.gpu_identity(torch_dev)
    cfg = BenchConfig(
        n_tracks=n_tracks,  # modes = min(n_tracks*1024, 1M); default 1M
        buffer_size=512,
        n_runs=n_runs,
        warmup=warmup,
        device_timing=False,
        verification="spot",
        pipeline_depth=pipeline_depth,
    )
    launches0 = modal_ops.KERNEL_LAUNCHES["modal_bank"]
    bench = create_benchmark("ModalFilterBank", cfg, torch_dev)
    bench.setup()
    result = run_benchmark(bench, cfg, verbose=False)
    launches = modal_ops.KERNEL_LAUNCHES["modal_bank"] - launches0
    ident = {
        "backend": "torch-cuda" if torch_dev.type == "cuda" else "torch-cpu",
        "device_name": identity["device_name"],
        "power_limit": identity["power_limit"],
        "kernel_launches": launches,
    }
    if result.validation is not None and not result.validation.passed:
        print(json.dumps({
            "metric": METRIC,
            "value": float("nan"),
            "unit": "ms",
            "vs_baseline": 0.0,
            "error": "validation failed",
            "messages": result.validation.messages[:3],
            **ident,
        }))
        return 1

    # value = MEDIAN over the saturated reps (each rep is already a mean
    # over pipeline_depth blocks); the min ships alongside.
    sat_p50 = result.saturated_statistics.median
    sat_min = result.saturated_statistics.min_val
    rec = {
        "metric": METRIC,
        "value": round(sat_p50, 4),
        "unit": "ms",
        "value_stat": "rep_p50",
        "vs_baseline": round(BASELINE_PC_P50_MS / sat_p50, 3),
        "blocks_per_sec_per_chip": round(1000.0 / sat_p50, 1),
        "saturated_rep_p50_ms": round(sat_p50, 4),
        "saturated_rep_min_ms": round(sat_min, 4),
        "roundtrip_p50_ms": round(result.statistics.median, 3),
        "roundtrip_p99_ms": round(result.statistics.p99, 3),
        "validation": "passed",
        # Largest spot-check error against the NumPy golden, relative to
        # the golden's peak (tolerance 1e-4).
        "validation_max_error": result.validation.max_error,
    }
    # Marginal tier: depth-differenced per-block cost with the fixed
    # per-chain costs (the probe read, the first launches) cancelled.
    if result.saturated_marginal_statistics is not None:
        marg_p50 = result.saturated_marginal_statistics.median
        rec["saturated_marginal_p50_ms"] = round(marg_p50, 4)
        rec["marginal_lo_depth"] = result.saturated_lo_depth
        if marg_p50 > 0:
            rec["blocks_per_sec_marginal"] = round(1000.0 / marg_p50, 1)
    rec["impl"] = result.metadata["impl"]
    rec.update(ident)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
