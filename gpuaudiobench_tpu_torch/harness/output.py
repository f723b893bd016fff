"""Result printing and the JSON result.

PyTorch counterpart of two functions of
``gpuaudiobench_tpu/harness/output.py``: ``generate_json_results`` (the
JSON of cuda/globals.cu:137-182 with the reference's extended sections)
and ``print_results`` (globals.cu:26-67). Every key of the reference's
JSON whose field the port's ``BenchmarkResult`` has is written under the
same name; a section the port cannot fill (the co-located projection)
is left out, never written as 0. The ``metadata.roofline`` section
(``harness/runner.py``) is there on a CUDA device only, and
``print_results`` prints it as the reference's ``Roofline [...]`` line.
Under DAW-sim the ``deadline`` section also names the pacer that ran,
``pacer: "native" | "python"`` (a key the reference lacks), so a
fallback to the Python pacer shows. The CSV writer is not ported yet
(ROADMAP.md queue 1, item 17a).

One departure: the reference takes the saturated marginal as the
blocks/s basis whenever it is above 0 (``output.py:89``), so a body
below timer noise can publish a rate above its own device tier. Here the
marginal is the basis only when its median is above its own dispersion
(the median absolute deviation of the per-rep marginals) and no faster
than the device tier's median; otherwise the amortized wall/depth is,
and ``blocks_per_sec_basis`` says which.
"""

from __future__ import annotations

import statistics as pystats
from typing import Optional

import torch

from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.base import BenchmarkResult
from gpuaudiobench_tpu_torch.harness.statistics import (
    csv_percentile,
    detect_outliers,
    stability_rating,
)
from gpuaudiobench_tpu_torch.harness.validation import ValidationStatus


def _summary(latencies):
    svec = sorted(latencies)
    n = len(svec)
    return {
        "min_ms": svec[0] if n else 0.0,
        "max_ms": svec[-1] if n else 0.0,
        "avg_ms": sum(latencies) / n if n else 0.0,
        "p50_ms": csv_percentile(svec, 0.50),
        "p95_ms": csv_percentile(svec, 0.95),
        "p99_ms": csv_percentile(svec, 0.99),
    }


def marginal_noise(marginals) -> float:
    """Dispersion scale of the per-rep marginals: their median absolute
    deviation from their median."""
    if not marginals:
        return 0.0
    med = pystats.median(marginals)
    return pystats.median(abs(v - med) for v in marginals)


def saturated_basis(result: BenchmarkResult):
    """(sat_p50, marginal_p50 | None, blocks_per_sec, basis): blocks/s
    from the marginal when it is above its noise and no faster than the
    device p50, else from the amortized wall/depth."""
    sat_p50 = csv_percentile(sorted(result.saturated_latencies), 0.50)
    marg_p50 = None
    if result.saturated_marginal_statistics is not None:
        marg = result.saturated_marginal_latencies
        marg_p50 = csv_percentile(sorted(marg), 0.50)
        device_p50: Optional[float] = (
            result.device_statistics.median
            if result.device_statistics is not None else None)
        if (marg_p50 > marginal_noise(marg)
                and (device_p50 is None or marg_p50 >= device_p50)):
            return sat_p50, marg_p50, 1000.0 / marg_p50, "marginal"
    bps = 1000.0 / sat_p50 if sat_p50 > 0 else 0.0
    return sat_p50, marg_p50, bps, "amortized"


def device_identity(device: Optional[torch.device]) -> dict:
    """The JSON's ``device`` section: the card's name and power limit on
    CUDA, "cpu" otherwise."""
    from gpuaudiobench_tpu_torch.utils.device import gpu_identity

    if device is None or device.type != "cuda":
        return {"kind": "cpu", "platform": "cpu", "timing_environment": "cpu"}
    ident = gpu_identity(device)
    return {"kind": ident["device_name"], "platform": "gpu",
            "timing_environment": "local",
            "power_limit": ident["power_limit"]}


def generate_json_results(result: BenchmarkResult, cfg: BenchConfig,
                          device: Optional[torch.device] = None) -> dict:
    stats = _summary(result.latencies)
    threshold = cfg.deadline_ms()
    out = {
        "benchmark": result.benchmark_name,
        "configuration": {
            "fs": cfg.fs,
            "bufferSize": cfg.buffer_size,
            "nTracks": cfg.n_tracks,
            "nRuns": len(result.latencies),
        },
        "statistics": stats,
        "deadline": {
            "threshold_ms": threshold,
            "meets_deadline": bool(stats["p99_ms"] <= threshold),
        },
    }
    s = result.statistics
    cv, rating = stability_rating(result.latencies)
    outliers, _, _ = detect_outliers(result.latencies)
    stats.update({
        "median_ms": s.median,
        "stddev_ms": s.std_dev,
        "cv_percent": cv,
        "stability": rating,
        "outlier_count": len(outliers),
    })
    if result.device_statistics is not None:
        d = result.device_statistics
        out["device_statistics"] = {
            "median_ms": d.median,
            "p95_ms": d.p95,
            "p99_ms": d.p99,
            "mean_ms": d.mean,
            "min_ms": d.min_val,
            "max_ms": d.max_val,
            "method": result.device_timing_method,
        }
    if result.saturated_statistics is not None:
        ss = result.saturated_statistics
        sat = _summary(result.saturated_latencies)
        _, _, bps, basis = saturated_basis(result)
        sat_cv, sat_rating = stability_rating(result.saturated_latencies)
        out["saturated"] = {
            "pipeline_depth": result.pipeline_depth,
            "p50_ms": sat["p50_ms"],
            "p95_ms": sat["p95_ms"],
            "p99_ms": sat["p99_ms"],
            "mean_ms": ss.mean,
            "min_ms": ss.min_val,
            "amortized_note": (
                "p50/p95/p99 are wall/depth of one chain of launches "
                "(includes the fixed sync and read cost divided by the "
                "depth); 'marginal' is the depth-differenced per-block "
                "cost with that cost cancelled"
            ),
            "blocks_per_sec": bps,
            "blocks_per_sec_basis": basis,
            "reps": ss.count,
            "cv_percent": sat_cv,
            "stability": sat_rating,
            "meets_deadline": bool(sat["p99_ms"] <= threshold),
            "raw_ms": [round(v, 6) for v in result.saturated_latencies],
        }
        if result.saturated_marginal_statistics is not None:
            ms = result.saturated_marginal_statistics
            mvec = sorted(result.saturated_marginal_latencies)
            out["saturated"]["marginal"] = {
                "lo_depth": result.saturated_lo_depth,
                "p50_ms": csv_percentile(mvec, 0.50),
                "p95_ms": csv_percentile(mvec, 0.95),
                "mean_ms": ms.mean,
                "min_ms": ms.min_val,
                "raw_ms": [round(v, 6)
                           for v in result.saturated_marginal_latencies],
            }
    if result.overlap_statistics is not None:
        os_, ov = result.overlap_serial_statistics, result.overlap_statistics
        out["overlapped"] = {
            "depth": result.overlap_depth,
            # Serial twin: upload -> compute -> probe read per block.
            "serial_p50_ms": os_.median,
            "overlapped_p50_ms": ov.median,
            "overlapped_p95_ms": ov.p95,
            "speedup_vs_serial": (os_.median / ov.median
                                  if ov.median > 0 else 0.0),
            "reps": ov.count,
            "serial_raw_ms": [round(v, 6)
                              for v in result.overlap_serial_latencies],
            "overlapped_raw_ms": [round(v, 6)
                                  for v in result.overlap_latencies],
            "meets_deadline": bool(ov.p95 <= threshold),
        }
    out["performance"] = {
        "throughput_gbps": result.throughput_gbps,
        "samples_per_sec": result.samples_per_sec,
        "bytes_processed": result.bytes_processed,
    }
    if result.validation is not None:
        v = result.validation
        out["validation"] = {
            "status": v.status.value,
            "max_error": v.max_error,
            "mean_error": v.mean_error,
            "error_count": v.error_count,
            "samples_checked": v.samples_checked,
        }
    if result.deadline_miss_rate is not None:
        out["deadline"]["miss_rate_percent"] = result.deadline_miss_rate
        out["deadline"]["pacer"] = result.dawsim_pacer
    out["device"] = device_identity(device)
    if result.metadata:
        out["metadata"] = result.metadata
    out["raw_latencies_ms"] = [round(v, 6) for v in result.latencies]
    return out


def print_results(result: BenchmarkResult, cfg: BenchConfig) -> None:
    """Human-readable summary (globals.cu:26-67 + bench_base.cu:129-150)."""
    s = result.statistics
    print(f"\n=== {result.benchmark_name} ===")
    print(f"Min: {s.min_val:.3f} Max: {s.max_val:.3f} Avg: {s.mean:.3f}")
    st = _summary(result.latencies)
    p50, p95, p99 = st["p50_ms"], st["p95_ms"], st["p99_ms"]
    print(f"p50: {p50:.3f} p95: {p95:.3f} p99: {p99:.3f}")
    threshold = cfg.deadline_ms()
    print(f"Latency threshold ({cfg.fs}Hz): {threshold:.3f} ms")
    if p50 > threshold:
        print("WARNING: p50 exceeds threshold")
    elif p95 > threshold:
        print("WARNING: p95 exceeds threshold")
    elif p99 > threshold:
        print("WARNING: p99 exceeds threshold")
    else:
        print("OK: Measured latencies within threshold. Please consider a "
              "margin of safety.")
    cv, rating = stability_rating(result.latencies)
    print(f"Run-to-run CV: {cv:.1f}% ({rating})")

    if result.device_statistics is not None:
        d = result.device_statistics
        print(f"Device Median:  {d.median:.4f} ms [{result.device_timing_method}]")
        print(f"Device P95:     {d.p95:.4f} ms")
        print(f"Device Mean:    {d.mean:.4f} ms")

    if result.saturated_statistics is not None:
        ss = result.saturated_statistics
        sat = _summary(result.saturated_latencies)
        verdict = "meets" if sat["p99_ms"] <= threshold else "MISSES"
        sat_cv, sat_rating = stability_rating(result.saturated_latencies)
        _, marg_p50, bps, basis = saturated_basis(result)
        print(
            f"Saturated amortized (depth {result.pipeline_depth}): "
            f"p50 {sat['p50_ms']:.3f} p95 {sat['p95_ms']:.3f} "
            f"p99 {sat['p99_ms']:.3f} ms/block (wall/depth), "
            f"min {ss.min_val:.3f}, CV {sat_cv:.1f}% ({sat_rating}) "
            f"({verdict} deadline on p99)")
        if marg_p50 is not None:
            print(
                f"Saturated marginal (depth "
                f"{result.saturated_lo_depth}->{result.pipeline_depth}): "
                f"p50 {marg_p50:.4f} ms/block, {bps:.1f} blocks/s [{basis}]")
        else:
            print(f"{bps:.1f} blocks/s [{basis}]")

    if result.overlap_statistics is not None:
        os_, ov = result.overlap_serial_statistics, result.overlap_statistics
        sp = os_.median / ov.median if ov.median > 0 else 0.0
        print(f"Overlapped infeed (depth {result.overlap_depth}): "
              f"p50 {ov.median:.3f} ms/block vs serial {os_.median:.3f} "
              f"({sp:.2f}x; upload double-buffered against compute)")

    print("\nPerformance Metrics:")
    print(f"Throughput:        {result.throughput_gbps:.3f} GB/s")
    print(f"Samples/sec:       {result.samples_per_sec:.0f}")
    print(f"Bytes processed:   {result.bytes_processed}")

    rl = result.metadata.get("roofline") if result.metadata else None
    if rl:
        flops_pct = rl.get("flops_pct_of_peak")
        flops_part = (
            f"{rl['achieved_gflops']:.1f} GFLOP/s"
            + (f" ({flops_pct:.1f}% of {rl['unit']} peak)"
               if flops_pct is not None else ""))
        bound = rl["bound"]
        if bound == "latency" and "nearest_wall" in rl:
            bound = (f"latency-bound (unsaturated; nearest wall "
                     f"{rl['nearest_wall']} at {rl['nearest_wall_pct']:.1f}%)")
        else:
            bound = f"{bound}-bound"
        print(f"Roofline [{rl['basis']}]: {flops_part}, "
              f"{rl['achieved_gbps']:.1f} GB/s HBM "
              f"({rl['hbm_pct_of_peak']:.1f}% of peak) -> {bound} "
              f"[{rl['peak_source']}]")

    if result.deadline_miss_rate is not None:
        print(f"Deadline miss rate: {result.deadline_miss_rate:.1f}% "
              f"({result.dawsim_pacer} pacer)")

    v = result.validation
    if v is not None:
        if v.status == ValidationStatus.SKIPPED:
            print("Validation skipped")
        elif v.passed:
            print(f"Validation passed (max_error={v.max_error:.3g}, "
                  f"mean_error={v.mean_error:.3g}, checked={v.samples_checked})")
        else:
            print(f"Validation FAILED for {result.benchmark_name}:")
            for msg in v.messages[:12]:
                print(f"  {msg}")
