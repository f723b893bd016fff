"""Result printing, the JSON result, the CSV writer and the latency file.

PyTorch counterpart of ``gpuaudiobench_tpu/harness/output.py``:
``generate_json_results`` (the JSON of cuda/globals.cu:137-182 with the
reference's extended sections), ``print_results`` (globals.cu:26-67),
``write_csv_results`` and ``csv_from_json_results`` (the CUDA schema of
globals.cu:69-122 with the saturated, marginal and context columns, or
Metal's schema, main.swift:256; header detection on append) and
``write_latencies_file`` (bench_utils.cu:416-442). Every key of the
reference's JSON whose field the port's ``BenchmarkResult`` has is
written under the same name; a section the port cannot fill (the
co-located projection) is left out, never written as 0, and the CSV's
``projected_ms`` column stays empty. The ``metadata.roofline`` section
(``harness/runner.py``) is there on a CUDA device only, and
``print_results`` prints it as the reference's ``Roofline [...]`` line.
Under DAW-sim the ``deadline`` section also names the pacer that ran,
``pacer: "native" | "python"`` (a key the reference lacks), so a
fallback to the Python pacer shows.

Departures:

* The reference takes the saturated marginal as the blocks/s basis
  whenever it is above 0 (``output.py:89``), so a body below timer noise
  can publish a rate above its own device tier. Here the marginal is the
  basis only when its median is above its own dispersion (the median
  absolute deviation of the per-rep marginals) and no faster than the
  device tier's median; otherwise the amortized wall/depth is, and
  ``blocks_per_sec_basis`` says which. The CSV's ``blocks_per_sec`` and
  basis columns come from the same ``saturated_basis``.
* Where the marginal tier was asked for and gave no marginal, the
  reference's live CSV row writes a basis and its JSON-derived row
  leaves it empty (``output.py:155``); where the saturated tier was asked
  for and the benchmark has no streaming mode, its derived CSV loses the
  saturated columns that the live one keeps empty. Here the JSON keeps
  ``saturated.marginal: null`` and ``saturated: {"pipeline_depth",
  "skipped"}`` for them, and the CSV is derived from the JSON alone
  (``_cuda_row``), so the live row and the derived row are the same
  text.
* The latency file's default path is ``<temp dir>/<name>_latencies.txt``
  (``tempfile.gettempdir()``, which follows ``TMPDIR``), the reference's
  ``/tmp/<name>_latencies.txt`` where ``TMPDIR`` is unset.
"""

from __future__ import annotations

import os
import statistics as pystats
import tempfile
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
        elif _marginal_mode(cfg):
            # Asked for and not there: the CSV still has its columns.
            out["saturated"]["marginal"] = None
    elif cfg.pipeline_depth > 1:
        # Asked for, and the benchmark has no streaming mode: the CSV
        # still has the (empty) columns.
        out["saturated"] = {"pipeline_depth": cfg.pipeline_depth,
                            "skipped": "no streaming mode"}
        if _marginal_mode(cfg):
            out["saturated"]["marginal"] = None
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


CSV_HEADER = (
    "benchmark,fs,bufferSize,nTracks,nRuns,min_ms,max_ms,avg_ms,"
    "p50_ms,p95_ms,p99_ms,threshold_ms,meets_deadline"
)
# With --pipelineDepth: the saturated tier's p50/p95/p99 (wall/depth),
# blocks/s and its deadline verdict on p99 (blank without a stream).
CSV_SATURATED_COLS = (
    ",saturated_p50_ms,saturated_p95_ms,saturated_p99_ms"
    ",blocks_per_sec,saturated_meets_deadline"
)
# With the marginal tier: its p50 and the basis of blocks_per_sec.
CSV_MARGINAL_COLS = ",saturated_marginal_p50_ms,blocks_per_sec_basis"
# Always: the device tier's method, the co-located projection (empty:
# not ported) and the timing environment ("local" on a GPU, "cpu").
CSV_CONTEXT_COLS = ",device_timing_method,projected_ms,timing_environment"
# Metal's alternate schema (metal-swift/.../main.swift:256,320).
METAL_CSV_HEADER = (
    "benchmark,median_ms,p95_ms,p99_ms,max_ms,mean_ms,stddev_ms,count"
)


def _marginal_mode(cfg: BenchConfig) -> bool:
    """Whether the runner measures the marginal tier (``harness/runner.py``)."""
    return cfg.pipeline_depth >= 4 and cfg.saturated_marginal


def _check_existing_header(filename: str, expected: str) -> bool:
    """True when the file needs a header; raises ``ValueError`` when it
    has one of another schema (rows under a different header would
    corrupt it)."""
    if not os.path.exists(filename):
        return True
    with open(filename) as f:
        first = f.readline().rstrip("\n")
    if first and first != expected:
        raise ValueError(
            f"{filename} already has a different CSV schema "
            f"(found {first.split(',')[0]}...-header with "
            f"{len(first.split(','))} columns, this run writes "
            f"{len(expected.split(','))}); use a new --outputfile"
        )
    return not first


def _append_row(filename: str, header: str, row: str) -> None:
    write_header = _check_existing_header(filename, header)
    with open(filename, "a") as f:
        if write_header:
            f.write(header + "\n")
        f.write(row + "\n")
    print(f"Results saved to: {filename}")


def _cuda_header(saturated_mode: bool, marginal_mode: bool) -> str:
    return (CSV_HEADER + (CSV_SATURATED_COLS if saturated_mode else "")
            + (CSV_MARGINAL_COLS if marginal_mode else "")
            + CSV_CONTEXT_COLS)


def _cuda_row(rec: dict, saturated_mode: bool, marginal_mode: bool) -> str:
    """One CUDA-schema row from a JSON result (``generate_json_results``):
    the one derivation both CSV surfaces use."""
    c, s, d = rec["configuration"], rec["statistics"], rec["deadline"]
    row = (
        f'{rec["benchmark"]},{c["fs"]},{c["bufferSize"]},{c["nTracks"]},'
        f'{c["nRuns"]},{s["min_ms"]:g},{s["max_ms"]:g},{s["avg_ms"]:g},'
        f'{s["p50_ms"]:g},{s["p95_ms"]:g},{s["p99_ms"]:g},'
        f'{d["threshold_ms"]:g},'
        f'{"true" if d["meets_deadline"] else "false"}'
    )
    if saturated_mode:
        sat = rec.get("saturated")
        if sat and sat.get("p50_ms", 0) > 0:
            row += (f',{sat["p50_ms"]:g},{sat["p95_ms"]:g},'
                    f'{sat["p99_ms"]:g},{sat["blocks_per_sec"]:g},'
                    f'{"true" if sat["meets_deadline"] else "false"}')
            if marginal_mode and "marginal" in sat:
                marg = sat["marginal"]  # null: asked for, none came
                marg_s = f'{marg["p50_ms"]:g}' if marg else ""
                row += f',{marg_s},{sat["blocks_per_sec_basis"]}'
            elif marginal_mode:  # not asked for (another run's columns)
                row += ",,"
        else:
            row += ",,,,," + (",," if marginal_mode else "")
    method = (rec.get("device_statistics") or {}).get("method") or ""
    env = (rec.get("device") or {}).get("timing_environment") or ""
    return row + f",{method},,{env}"


def write_csv_results(result: BenchmarkResult, cfg: BenchConfig,
                      filename: str,
                      device: Optional[torch.device] = None) -> None:
    """Appends the run's row to ``filename`` (a header first when the file
    is new or empty; ``ValueError`` when it has another schema's).
    ``device`` is the one the run used, for ``timing_environment``."""
    if not filename:
        return
    if cfg.csv_schema == "metal":
        s = result.statistics
        _append_row(filename, METAL_CSV_HEADER, (
            f"{result.benchmark_name},{s.median:g},{s.p95:g},{s.p99:g},"
            f"{s.max_val:g},{s.mean:g},{s.std_dev:g},{s.count}"))
        return
    saturated_mode = cfg.pipeline_depth > 1
    marginal_mode = _marginal_mode(cfg)
    rec = generate_json_results(result, cfg, device)
    _append_row(filename, _cuda_header(saturated_mode, marginal_mode),
                _cuda_row(rec, saturated_mode, marginal_mode))


def csv_from_json_results(results: list) -> str:
    """The CUDA-schema CSV of JSON results: the saturated columns when one
    of them has a saturated section, the marginal ones when one has a
    ``saturated.marginal`` key (null where the tier gave nothing)."""
    saturated_mode = any(r.get("saturated") for r in results)
    marginal_mode = any("marginal" in (r.get("saturated") or {})
                        for r in results)
    lines = [_cuda_header(saturated_mode, marginal_mode)]
    lines += [_cuda_row(r, saturated_mode, marginal_mode) for r in results]
    return "\n".join(lines) + "\n"


def write_latencies_file(result: BenchmarkResult, filename: str = "") -> None:
    """Raw latency dump with a stats header (bench_utils.cu:416-442);
    default path ``<temp dir>/<name>_latencies.txt``."""
    if not filename:
        filename = os.path.join(tempfile.gettempdir(),
                                f"{result.benchmark_name}_latencies.txt")
    s = result.statistics
    with open(filename, "w") as f:
        f.write("# Latency Statistics (ms)\n")
        f.write(f"# Count: {s.count}\n")
        f.write(f"# Mean: {s.mean:.3f}\n")
        f.write(f"# Median: {s.median:.3f}\n")
        f.write(f"# Std Dev: {s.std_dev:.3f}\n")
        f.write(f"# Min: {s.min_val:.3f}\n")
        f.write(f"# Max: {s.max_val:.3f}\n")
        f.write(f"# P95: {s.p95:.3f}\n")
        f.write(f"# P99: {s.p99:.3f}\n")
        f.write("#\n# Raw latencies:\n")
        for v in result.latencies:
            f.write(f"{v:.6f}\n")


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
