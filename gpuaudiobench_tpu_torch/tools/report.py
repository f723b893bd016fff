"""Static HTML report: the port's results as one dependency-free page.

The port's copy of the repo-level ``tools/report.py`` (the reference's
WebGPU UI, webgpu/index.html + js/app.js, as a file): latency
histograms with deadline markers, the suite table, the comparison with
the DAFx-24 poster's published numbers (``analysis/compare.py``) and a
hardware panel from the JSON's ``device`` section (the card's name and
power limit), rendered from the port's JSON (one object or an array).

Usage:
  python -m gpuaudiobench_tpu_torch.cli --benchmarkFilter /.*/ --json \
      --outputfile results.json
  python -m gpuaudiobench_tpu_torch.tools.report results.json \
      [-o <temp dir>/report.html] [--title ...]
"""

from __future__ import annotations

import argparse
import html
import json
import os
import sys
import tempfile
from typing import List, Optional

from gpuaudiobench_tpu_torch.analysis.compare import (
    NOTES,
    PUBLISHED,
    card_label,
)


def _histogram_svg(latencies: List[float], threshold_ms: float,
                   width: int = 420, height: int = 120, bins: int = 30) -> str:
    """Inline-SVG latency histogram with the deadline marker
    (Statistics.histogram + Chart.js analog, webgpu Statistics.js)."""
    if not latencies:
        return "<svg></svg>"
    lo, hi = min(latencies), max(latencies)
    span = (hi - lo) or 1e-9
    counts = [0] * bins
    for v in latencies:
        idx = min(int((v - lo) / span * bins), bins - 1)
        counts[idx] += 1
    peak = max(counts) or 1
    bar_w = width / bins
    bars = []
    for i, c in enumerate(counts):
        h = (c / peak) * (height - 14)
        bars.append(
            f'<rect x="{i * bar_w:.1f}" y="{height - h:.1f}" '
            f'width="{bar_w - 1:.1f}" height="{h:.1f}" fill="#4a7dbd"/>'
        )
    marker = ""
    if lo <= threshold_ms <= hi:
        mx = (threshold_ms - lo) / span * width
        marker = (
            f'<line x1="{mx:.1f}" y1="0" x2="{mx:.1f}" y2="{height}" '
            f'stroke="#c0392b" stroke-dasharray="4,3"/>'
        )
    return (
        f'<svg width="{width}" height="{height}" '
        f'style="background:#f7f9fb;border:1px solid #d8dee6">'
        + "".join(bars) + marker +
        f'<text x="2" y="10" font-size="9" fill="#555">{lo:.2f} ms</text>'
        f'<text x="{width - 50}" y="10" font-size="9" fill="#555">{hi:.2f} ms</text>'
        "</svg>"
    )


def _baseline_section(results: List[dict], card: str) -> str:
    rows = []
    for r in results:
        name = r.get("benchmark", "")
        if name not in PUBLISHED:
            continue
        pub = PUBLISHED[name]
        sat = r.get("saturated") or {}
        ours = sat.get("p50_ms") or r.get("statistics", {}).get("p50_ms", 0)
        basis = "saturated" if sat.get("p50_ms") else "round-trip"
        pc = pub.get("PC", (None,))[0]
        asy = pub.get("AS", (None,))[0]
        speed = f"{pc / ours:.1f}×" if (pc and ours) else "—"
        rows.append(
            "<tr>"
            f"<td>{html.escape(name)}</td>"
            f"<td>{pc if pc is not None else '—'}</td>"
            f"<td>{asy if asy is not None else '—'}</td>"
            f"<td>{ours:.3f} ({basis})</td>"
            f"<td>{speed}</td>"
            f"<td style='text-align:left;color:#777'>{html.escape(NOTES.get(name, ''))}</td>"
            "</tr>"
        )
    if not rows:
        return ""
    return (
        "<h2>vs published baselines (DAFx-24 poster)</h2>"
        "<table border='0' cellspacing='0' cellpadding='6' "
        "style='border-collapse:collapse;font-size:13px'>"
        "<tr style='background:#eef2f6'><th>benchmark</th>"
        "<th>RTX 4070 p50</th><th>M2 Pro p50</th>"
        f"<th>{html.escape(card)} ms</th>"
        "<th>vs PC</th><th>note</th></tr>"
        + "".join(rows) + "</table>"
    )


def _hardware(device: Optional[dict]) -> str:
    if not device:
        return ""
    env = device.get("timing_environment")
    return (f"<p>Hardware: <b>{html.escape(card_label(device))}</b> "
            f"[{html.escape(device.get('platform', ''))}"
            + (f", timing {html.escape(env)}" if env else "") + "]</p>")


def _card_bits(r: dict) -> str:
    """The detail line under a benchmark's histogram."""
    dev, sat = r.get("device_statistics"), r.get("saturated")
    meta = r.get("metadata") or {}
    bits = []
    if dev:
        method = dev.get("method", "")
        bits.append(
            f"device median {dev['median_ms']:.4f} ms"
            + (f" [{html.escape(method)}]" if method else ""))
    if sat and sat.get("p50_ms"):
        marg = sat.get("marginal")
        basis = sat.get("blocks_per_sec_basis", "")
        bits.append(
            f"saturated {sat['p50_ms']:.3f} ms/block"
            + (f", marginal {marg['p50_ms']:.4f} ms/block" if marg else "")
            + f" ({sat['blocks_per_sec']:.0f} blocks/s"
            + (f" [{html.escape(basis)}]" if basis else "")
            + f", depth {sat['pipeline_depth']})")
    ov = r.get("overlapped")
    if ov:
        bits.append(
            f"overlapped infeed {ov['overlapped_p50_ms']:.3f} ms/block vs "
            f"serial {ov['serial_p50_ms']:.3f} "
            f"({ov['speedup_vs_serial']:.2f}x, depth {ov['depth']})")
    rl = meta.get("roofline")
    if rl:
        pct = rl.get("flops_pct_of_peak")
        bits.append(
            f"roofline: {rl['achieved_gflops']:.1f} GFLOP/s"
            + (f" ({pct:.1f}% {html.escape(rl.get('unit', ''))})"
               if pct is not None else "")
            + f", {rl['achieved_gbps']:.1f} GB/s HBM "
            + f"({rl['hbm_pct_of_peak']:.1f}%) &rarr; {rl['bound']}-bound"
            + f" [peaks: {html.escape(rl.get('peak_source', ''))}, "
            + f"basis {html.escape(rl.get('basis', ''))}]")
    return " &middot; ".join(bits)


def generate_report(results: List[dict],
                    title: str = "tpuaudiobench results (PyTorch port)") -> str:
    rows, cards = [], []
    for r in results:
        name = html.escape(r.get("benchmark", "?"))
        stats = r.get("statistics", {})
        deadline = r.get("deadline", {})
        perf = r.get("performance", {})
        val = r.get("validation", {})
        badge = (
            '<span style="color:#1e8449">&#10004; meets deadline</span>'
            if deadline.get("meets_deadline", False) else
            '<span style="color:#c0392b">&#10008; misses deadline</span>'
        )
        status = val.get("status", "n/a")
        vbadge = (
            '<span style="color:#1e8449">validated</span>'
            if status == "SUCCESS"
            else f'<span style="color:#c0392b">{html.escape(str(status))}</span>'
        )
        dev = r.get("device_statistics")
        sat = r.get("saturated") or {}
        dev_cell = f"{dev['median_ms']:.4f}" if dev else "&mdash;"
        sat_cell = (f"{sat['p50_ms']:.3f}" if sat.get("p50_ms")
                    else "&mdash;")
        rl = (r.get("metadata") or {}).get("roofline")
        if rl:
            pct_v = rl.get("flops_pct_of_peak")
            peak_cell = (
                f"{pct_v:.1f}% {html.escape(rl.get('unit', ''))}"
                if pct_v is not None
                else f"{rl.get('hbm_pct_of_peak', 0):.1f}% hbm")
        else:
            peak_cell = "&mdash;"
        rows.append(
            "<tr>"
            f"<td>{name}</td>"
            f"<td>{stats.get('p50_ms', 0):.3f}</td>"
            f"<td>{stats.get('p95_ms', 0):.3f}</td>"
            f"<td>{stats.get('p99_ms', 0):.3f}</td>"
            f"<td>{dev_cell}</td>"
            f"<td>{sat_cell}</td>"
            f"<td>{peak_cell}</td>"
            f"<td>{deadline.get('threshold_ms', 0):.3f}</td>"
            f"<td>{badge}</td>"
            f"<td>{vbadge}</td>"
            f"<td>{perf.get('throughput_gbps', 0):.3f}</td>"
            "</tr>"
        )
        latencies = r.get("raw_latencies_ms", [])
        hist = (_histogram_svg(latencies, deadline.get("threshold_ms", 0.0))
                if latencies else "<i>no raw latencies in result</i>")
        meta = dict(r.get("metadata") or {})
        meta.pop("roofline", None)
        meta_str = html.escape(json.dumps(meta)) if meta else ""
        cards.append(
            f"<h3>{name}</h3>{hist}"
            f"<p style='font-size:12px;color:#555'>{_card_bits(r)}"
            f"<br>{meta_str}</p>")

    table = (
        "<table border='0' cellspacing='0' cellpadding='6' "
        "style='border-collapse:collapse;font-size:13px'>"
        "<tr style='background:#eef2f6'>"
        "<th>benchmark</th><th>p50</th><th>p95</th><th>p99</th>"
        "<th>device ms</th><th>saturated ms/blk</th>"
        "<th>% of peak</th><th>deadline</th>"
        "<th>status</th><th>validation</th><th>GB/s</th></tr>"
        + "".join(rows) + "</table>"
    )
    device = next((r.get("device") for r in results if r.get("device")),
                  None)
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title>"
        "<style>body{font-family:system-ui,sans-serif;margin:2em;color:#222}"
        "td,th{border-bottom:1px solid #e1e6eb;text-align:right}"
        "td:first-child,th:first-child{text-align:left}</style></head><body>"
        f"<h1>{html.escape(title)}</h1>" + _hardware(device) +
        "<p>Round-trip latencies in ms per full "
        "host&rarr;device&rarr;kernel&rarr;host iteration; device ms = "
        "the card's time for one block (CUDA events); saturated = a "
        "pipeline of state-carried blocks over its depth (see each card "
        "for the depth-differenced marginal where measured); deadline = "
        "1000&middot;bufferSize/fs.</p>"
        + table + _baseline_section(results, card_label(device))
        + "<hr>" + "".join(cards) + "</body></html>"
    )


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    """Reads a result file only: ``device`` is taken for the tools'
    common signature and runs nothing."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("results",
                    help="JSON results file (one object or an array)")
    ap.add_argument("-o", "--output", default=os.path.join(
        tempfile.gettempdir(), "report.html"))
    ap.add_argument("--title", default="tpuaudiobench results (PyTorch port)")
    args = ap.parse_args(argv)
    with open(args.results) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = [data]
    with open(args.output, "w") as f:
        f.write(generate_report(data, args.title))
    print(f"Report written to {args.output} ({len(data)} benchmarks)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
