"""Render the results markdown tables from the port's JSON results.

The port's copy of the repo-level ``tools/render_results.py``: the tables
of a results doc are generated from the JSON the harness wrote, inside
sentinel blocks, and ``--check`` fails when a doc's blocks no longer match
their JSON, so a doc cannot drift from its measurement.

Sentinels (the renderer owns everything between them; the JSON path is
relative to the doc):

    <!-- BEGIN generated:suite from RESULTS.json -->
    ...
    <!-- END generated:suite -->

Sections: ``suite`` (device / saturated / blocks/s / stability / max
error) and ``roofline`` (achieved rates against the card's measured
peaks). The reference's ``projection`` section (the co-located
projection of a relay round trip) is not ported, and an unknown section
raises. Each block opens with the card that ran its rows, its name and
power limit from the JSON's ``device`` section, on a line above the
table.

Usage:
    python -m gpuaudiobench_tpu_torch.tools.render_results RESULTS.md          # rewrite
    python -m gpuaudiobench_tpu_torch.tools.render_results RESULTS.md --check  # verify
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import List, Optional

from gpuaudiobench_tpu_torch.analysis.compare import card_label

BEGIN_RE = re.compile(
    r"<!-- BEGIN generated:(?P<section>[a-z]+) from (?P<src>[^ ]+) -->"
)
END_FMT = "<!-- END generated:{section} -->"


def _label(r: dict) -> str:
    """Benchmark display label with the qualifiers of its configuration,
    from the result's own metadata."""
    name = r["benchmark"]
    md = r.get("metadata") or {}
    if "eqStages" in md:
        return f"{name} ({md['eqStages']}-stage EQ, IR {md['irLength']})"
    if "irLength" in md:
        return f"{name} (IR {md['irLength']})"
    if "numModes" in md:
        return f"{name} ({md['numModes'] / 1000:g}k modes)"
    if "grid" in md:
        g = md["grid"]
        return f"{name} ({g[0]}³ × {md['stepsPerSample']} steps/sample)"
    if "poolMiB" in md:
        return f"{name} ({md['poolMiB']} MiB pool)"
    if "numStages" in md:
        return f"{name} ({md['numStages']} stages)"
    if "mesh" in md and isinstance(md["mesh"], dict):
        m = md["mesh"]
        return f"{name} (mesh {m['dp']},{m['tp']},{m['sp']})"
    if "devices" in md:
        return f"{name} ({md['devices']} device{'s' if md['devices'] != 1 else ''})"
    return name


def render_suite(results: list) -> str:
    # With a marginal tier in any row, it stands beside the amortized
    # wall / depth, and blocks/s names its basis.
    has_marginal = any(
        (r.get("saturated") or {}).get("marginal") for r in results
    )
    if has_marginal:
        lines = [
            "| Benchmark | device ms [method] | sat amortized ms/block "
            "(wall/depth) | sat marginal ms/block | blocks/s [basis] | "
            "stability (CV) | max err |",
            "|---|---:|---:|---:|---:|---|---:|",
        ]
    else:
        lines = [
            "| Benchmark | device ms [method] | saturated ms/block | blocks/s | stability (CV) | max err |",
            "|---|---:|---:|---:|---|---:|",
        ]
    for r in results:
        d = r.get("device_statistics") or {}
        sat = r.get("saturated")
        if sat and "p50_ms" not in sat:  # asked for; no streaming mode
            sat = None
        # Each row names its device-timing method.
        method = d.get("method", "")
        dev_ms = (
            f"{d['median_ms']:.4f} [{method}]" if d and method
            else (f"{d['median_ms']:.4f}" if d else "—")
        )
        marg_ms = "—"
        if sat:
            sat_ms = f"{sat['p50_ms']:.3f}"
            bps = f"{sat['blocks_per_sec']:.0f}"
            marg = sat.get("marginal")
            if marg is not None:
                marg_ms = f"{marg['p50_ms']:.4f}"
            basis = sat.get("blocks_per_sec_basis")
            if has_marginal and basis:
                bps = f"{bps} [{basis}]"
            # The variance of the tier the row headlines: saturated where
            # there is one, else the round trip's.
            cv, rating = sat.get("cv_percent"), sat.get("stability")
        else:
            sat_ms, bps = "n/a (transfer-bound)", "—"
            cv, rating = None, None
        if cv is None:
            cv = r["statistics"].get("cv_percent")
            rating = r["statistics"].get("stability")
        cv_s = f"{rating} ({cv:.0f}%)" if cv is not None else "—"
        err = r.get("validation", {}).get("max_error", 0.0)
        err_s = "0" if err == 0 else f"{err:.3g}"
        if has_marginal:
            lines.append(
                f"| {_label(r)} | {dev_ms} | {sat_ms} | {marg_ms} | "
                f"{bps} | {cv_s} | {err_s} |"
            )
        else:
            lines.append(
                f"| {_label(r)} | {dev_ms} | {sat_ms} | {bps} | {cv_s} | {err_s} |"
            )
    return "\n".join(lines)


def render_roofline(results: list) -> str:
    lines = [
        "| Benchmark | basis | GFLOP/s | % of peak | GB/s | % of HBM | bound | peak source |",
        "|---|---|---:|---:|---:|---:|---|---|",
    ]
    for r in results:
        rl = (r.get("metadata") or {}).get("roofline")
        if not rl:
            continue
        pct = rl.get("flops_pct_of_peak")
        pct_s = f"{pct:.1f}% ({rl['unit']})" if pct is not None else "—"
        gf = rl["achieved_gflops"]
        bound = rl["bound"]
        if bound == "latency" and "nearest_wall" in rl:
            bound = (
                f"latency (nearest wall {rl['nearest_wall']} "
                f"{rl['nearest_wall_pct']:.1f}%)"
            )
        lines.append(
            f"| {_label(r)} | {rl['basis']} | "
            f"{gf:.1f} | {pct_s} | {rl['achieved_gbps']:.1f} | "
            f"{rl['hbm_pct_of_peak']:.1f}% | {bound} | "
            f"{rl.get('peak_source', 'spec-estimate')} |"
        )
    return "\n".join(lines)


RENDERERS = {
    "suite": render_suite,
    "roofline": render_roofline,
}


def card_line(results: list) -> str:
    """The line above a generated table: the card (name and power limit)
    that ran its rows, each card once in the rows' order."""
    cards = list(dict.fromkeys(card_label(r.get("device")) for r in results))
    return "Measured on " + "; ".join(cards) + "."


def render(section: str, results: list) -> str:
    """A generated block's body: the card line, then the table."""
    return card_line(results) + "\n\n" + RENDERERS[section](results)


def process(md_path: str, check: bool = False) -> list:
    """Rewrite (or verify) every generated block in ``md_path``.
    Returns a list of drift descriptions (empty = in sync)."""
    with open(md_path) as f:
        text = f.read()
    out, pos, drift = [], 0, []
    for m in BEGIN_RE.finditer(text):
        section, src = m.group("section"), m.group("src")
        if section not in RENDERERS:
            raise ValueError(f"{md_path}: unknown generated section {section}")
        end_marker = END_FMT.format(section=section)
        end = text.find(end_marker, m.end())
        if end < 0:
            raise ValueError(f"{md_path}: missing {end_marker}")
        src_path = os.path.join(os.path.dirname(md_path), src)
        with open(src_path) as f:
            results = json.load(f)
        if isinstance(results, dict):
            results = [results]
        rendered = render(section, results)
        current = text[m.end():end].strip("\n")
        if current != rendered:
            drift.append(f"{md_path}: generated:{section} drifted from {src}")
        out.append(text[pos:m.end()])
        out.append("\n" + rendered + "\n")
        pos = end
    out.append(text[pos:])
    if not check:
        with open(md_path, "w") as f:
            f.write("".join(out))
    return drift


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    """Reads and writes files only: ``device`` is taken for the tools'
    common signature and runs nothing."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("md", nargs="+", help="results .md files with sentinels")
    ap.add_argument("--check", action="store_true",
                    help="verify only; exit 1 on drift")
    args = ap.parse_args(argv)
    all_drift = []
    for md in args.md:
        all_drift += process(md, check=args.check)
    if args.check:
        for d in all_drift:
            print(f"DRIFT: {d}", file=sys.stderr)
        if all_drift:
            return 1
    if not args.check:
        print(f"rendered {len(args.md)} file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
