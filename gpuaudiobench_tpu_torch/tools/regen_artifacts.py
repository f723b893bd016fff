"""Regenerate the port's suite artifacts from one harness run.

The port's counterpart of the repo-level ``tools/regen_artifacts.sh``, as
a module like the port's other tools:

1. the suite's JSON (the port's CLI over ``--benchmarkFilter``, default
   every name, at ``--nRuns 20 --pipelineDepth 256``), written through a
   ``.tmp`` file and renamed: the one measurement;
2. the CSV derived from that JSON (``tools.json_to_csv``);
3. ``RESULTS.md``, its ``suite`` and ``roofline`` tables rendered from the
   JSON (``tools.render_results``; the doc is written fresh where it does
   not exist, its generated blocks re-rendered where it does);
4. ``report.html`` (``tools.report``);
5. last, ``render_results --check`` on the doc.

Everything after the run derives from its JSON, so the artifacts cannot
disagree. A run that exits nonzero (a benchmark failed or did not
validate) stops before its JSON replaces the last one, as the reference's
script does, and leaves it in the ``.tmp`` file.

Usage: python -m gpuaudiobench_tpu_torch.tools.regen_artifacts [--out DIR]
           [--benchmarkFilter /./] [--nRuns 20] [--pipelineDepth 256]
           [--device cuda|cpu]
       (default DIR: <temp dir>/tpuaudiobench_artifacts)
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Optional

JSON_NAME, CSV_NAME, MD_NAME, HTML_NAME = (
    "RESULTS.json", "RESULTS.csv", "RESULTS.md", "report.html")

DOC = """# Suite results (PyTorch / CUDA port)

One run of `python -m gpuaudiobench_tpu_torch.cli` wrote {json}; the
tables below, {csv} and {html} are derived from it by
`python -m gpuaudiobench_tpu_torch.tools.regen_artifacts`.

## Suite

<!-- BEGIN generated:suite from {json} -->
<!-- END generated:suite -->

## Roofline

<!-- BEGIN generated:roofline from {json} -->
<!-- END generated:roofline -->
"""


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "tpuaudiobench_artifacts"))
    ap.add_argument("--benchmarkFilter", default="/./")
    ap.add_argument("--nRuns", type=int, default=20)
    ap.add_argument("--pipelineDepth", type=int, default=256)
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from gpuaudiobench_tpu_torch import cli
    from gpuaudiobench_tpu_torch.tools import json_to_csv, render_results, report

    os.makedirs(args.out, exist_ok=True)
    js, csv, md, html = (os.path.join(args.out, n)
                         for n in (JSON_NAME, CSV_NAME, MD_NAME, HTML_NAME))
    tmp = js + ".tmp"
    if os.path.exists(tmp):  # a run cut short leaves a partial one
        os.unlink(tmp)
    rc = cli.main(["--benchmarkFilter", args.benchmarkFilter,
                   "--nRuns", str(args.nRuns),
                   "--pipelineDepth", str(args.pipelineDepth),
                   "--json", "--outputfile", tmp], device=args.device)
    if rc != 0:
        print(f"regen_artifacts: the run exited {rc}; its JSON is left in "
              f"{tmp}")
        return rc
    os.replace(tmp, js)
    json_to_csv.main([js, csv])
    if not os.path.exists(md):
        with open(md, "w") as f:
            f.write(DOC.format(json=JSON_NAME, csv=CSV_NAME, html=HTML_NAME))
    render_results.main([md])
    report.main([js, "-o", html])
    # The doc's tables must re-render byte for byte from the JSON.
    rc = render_results.main([md, "--check"])
    print(f"artifacts: {csv} {js} {md} {html} (one run, derived)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
