"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m rtbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. With ``--trace 0`` the metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read from a profiled
sub-window after the measured one, with the device's busy and window
seconds and a breakdown. Every run compares what the window produced
with the plain reference and prints each compared number beside its
limit: last on standard error, and last in the result line, under
``checks``. The last line of standard output is the result, one JSON
object. A run exits with a code other than 0, and prints no result,
where there is no CUDA card or too few, where it finds ``jax``,
``jaxlib``, ``flax`` or the JAX package loaded once the window has
closed, or where anything fails.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

FOREIGN = ("jax", "jaxlib", "flax", "gpuaudiobench_tpu")
ROOT = Path(__file__).resolve().parents[1]
BYTECODE_DIR = ROOT / "build" / "pycache"


def cache_bytecode() -> None:
    """Keep the bytecode of every module the run imports in
    ``build/pycache`` inside the checkout, a fixed path, also where the
    environment asks that none be written (``PYTHONDONTWRITEBYTECODE``)
    and the installed packages hold none: the first run of a checkout
    compiles torch's sources, and later runs import them from there."""
    sys.pycache_prefix = str(BYTECODE_DIR)
    sys.dont_write_bytecode = False


def foreign_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is one the
    port must not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FOREIGN))


def power_limit() -> Optional[str]:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() else None


def say(*parts) -> None:
    print("rtbench:", *parts, file=sys.stderr, flush=True)


def result_line(cell, out: Dict, traced: bool, device_name: str,
                count: int) -> Dict:
    """The result object; ``checks`` comes last."""
    from rtbench import trace as tr

    metrics: Dict[str, Dict] = {}
    line: Dict = {"correct": bool(out["correct"]),
                  "attempted": int(out["attempted"]),
                  "failed": int(out["failed"]), "metrics": metrics}
    device = {"platform": "gpu", "kind": device_name, "count": count,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if traced:
        events, spans, blocks, units = out["trace"]
        view = tr.TraceView(kind=cell.kind, config=cell.config,
                            device_name=device_name, events=events,
                            spans=spans, blocks=blocks, units=units,
                            measured=out["measured"])
        for entry, reader in cell.readers():
            value = reader.read(view)
            if value is not None:
                metrics[entry["name"]] = {"value": float(value),
                                          "unit": entry["unit"]}
        device["busy_s"] = view.busy_us() * 1e-6
        device["window_s"] = view.window_us * 1e-6
        line["breakdown"] = tr.breakdown(view)
    else:
        for entry in cell.end_to_end:
            if entry["name"] not in out:
                raise KeyError(f"rtbench: {cell.name} measured no "
                               f"{entry['name']}")
            metrics[entry["name"]] = {"value": float(out[entry["name"]]),
                                      "unit": entry["unit"]}
    line["device"] = device
    line["checks"] = {k: {"value": v, "limit": out["limits"][k]}
                      for k, v in out["numbers"].items()}
    return line


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m rtbench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from rtbench import spec

    cell = spec.Cell(spec.load_benchmark(), args.workload)

    import torch

    from rtbench import harness

    setup = harness.Setup(_T_START)
    setup.mark("imports")

    if not torch.cuda.is_available():
        say("no CUDA device (torch.cuda.is_available() is False)")
        return 3
    if torch.cuda.device_count() < cell.chips:
        say(f"{cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} found")
        return 3

    device = torch.device("cuda:0")
    torch.zeros(1, device=device)
    setup.mark("cuda")
    seed = args.seed % (1 << 63)
    out = harness.run_cell(cell, seed, args.seconds, bool(args.trace), device,
                           setup)
    found = foreign_modules()
    if found:
        say("the process loaded", ", ".join(found), "- no result")
        return 4
    name = torch.cuda.get_device_name(device)
    line = result_line(cell, out, bool(args.trace), name, cell.chips)
    say(f"card: {power_limit() or name}")
    say("set-up phases (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["setup_phases"].items()))
    if "trace" in out:
        m = out["measured"]
        say(f"measured window: {m['window_us'] / m['units']:.3f} us a unit, "
            f"traced: {line['device']['window_s'] * 1e6 / out['trace'][3]:.3f}")
    say(f"reference and comparison: {out['reference_s']:.3f} s")
    if "late" in out:
        say(f"callbacks past the {cell.config['deadline_ms']} ms deadline: "
            f"{out['late']} of {out['attempted']}")
    for k, v in out["info"].items():
        say(f"not compared: {k} = {v!r}")
    for k, v in line["checks"].items():
        say(f"check {k} = {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    cache_bytecode()
    sys.exit(main())
