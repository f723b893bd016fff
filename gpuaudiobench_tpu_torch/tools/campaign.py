"""What the poster-table campaigns share: one benchmark run to its JSON
record, the card's label, and where a report goes.

``modal_sweep`` (tab4), ``transfer_tab5`` (tab5), ``rndmem_sweep``
(tab6), ``dawsim_campaign`` (tab7 / tab8) and ``lowlatency_sweep`` each
run the port's harness (``harness/runner.py``) through ``run_json`` and
name the card beside every number (``card``)."""

from __future__ import annotations

import gc
import json
import os
import tempfile
from typing import Dict, Tuple

import torch

from gpuaudiobench_tpu_torch.config import BenchConfig


def card(dev: torch.device) -> str:
    """The card's label as the JSON's ``device`` section gives it
    (``analysis.compare.card_label``): "<name>, <power limit>" on a CUDA
    device, "cpu" on the CPU."""
    from gpuaudiobench_tpu_torch.analysis.compare import card_label
    from gpuaudiobench_tpu_torch.harness.output import device_identity

    return card_label(device_identity(dev))


def run_json(name: str, cfg: BenchConfig, dev: torch.device) -> Dict:
    """Set up ``name`` under ``cfg`` on ``dev``, run the harness and
    return its JSON record (``harness.output.generate_json_results``).
    The benchmark, its chain graphs and their memory go before the next
    run (``gc.collect``, ``torch.cuda.empty_cache``), as the capacity
    tool's probes do: a sweep's widest point must not share the card."""
    from gpuaudiobench_tpu_torch.harness.output import generate_json_results
    from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
    from gpuaudiobench_tpu_torch.registry import create_benchmark
    from gpuaudiobench_tpu_torch.utils.device import fp32_convolutions

    fp32_convolutions(dev)
    bench = create_benchmark(name, cfg, dev)
    bench.setup()
    try:
        result = run_benchmark(bench, cfg, verbose=False)
        return generate_json_results(result, cfg, dev)
    finally:
        bench.cleanup()
        del bench
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def validated(rec: Dict) -> str:
    """"passed", "FAILED" or "not checked" (no check, or skipped) from a
    JSON record."""
    status = (rec.get("validation") or {}).get("status")
    if status in (None, "SKIPPED"):
        return "not checked"
    return "passed" if status == "SUCCESS" else "FAILED"


def out_base(arg: str, default: str) -> str:
    """The report's path without its extension: ``arg``, else ``default``
    in the temp dir."""
    path = arg or os.path.join(tempfile.gettempdir(), default)
    return path[:-3] if path.endswith(".md") else path


def write_report(base: str, payload: Dict, markdown: str) -> Tuple[str, str]:
    """``<base>.json`` (the payload) and ``<base>.md``; their paths."""
    with open(base + ".json", "w") as f:
        json.dump(payload, f, indent=2)
    with open(base + ".md", "w") as f:
        f.write(markdown)
    return base + ".json", base + ".md"


def fmt(v, digits: int = 3) -> str:
    return f"{v:.{digits}f}" if isinstance(v, (int, float)) else "—"
