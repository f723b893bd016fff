"""Mesh scaling ladder of the multi-device layer.

The port's copy of the repo-level ``tools/mesh_scaling.py``. It runs
MultiChipSuite and ICIBandwidth over a ladder of (dp, tp, sp) meshes on
the ranks of ``parallel/launch.py:spmd`` (NCCL with one rank a card on
the card; gloo ranks on the CPU, up to ``mesh.CPU_DEVICES``) and writes a
table of each run's round-trip p50, the collectives one step issued
(``metadata.collectiveInventory``: kind, bytes, axis size) and its
validation. The meshes of one rank count go in one launch
(``parallel/ranks.py:json_runs``). On gloo ranks the p50 is functional
(the mesh partitions and validates); it does not measure an
interconnect. A mesh with more ranks than there are devices is listed as
skipped. The reference's "predicted v5e ICI" column (its analytic model
of the TPU interconnect) is not ported.

Writes ``<out>.json`` (the rows) and ``<out>.md``.

Usage: python -m gpuaudiobench_tpu_torch.tools.mesh_scaling [out.md]
           [--device cuda|cpu]
       (default out: <temp dir>/mesh_scaling.md)
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np

from gpuaudiobench_tpu_torch.tools.campaign import (
    card,
    out_base,
    validated,
    write_report,
)

SUITE_MESHES = ["1,1,1", "2,1,1", "1,2,1", "1,1,2", "2,2,1", "2,2,2",
                "8,1,1", "1,8,1", "1,1,8"]
ICI_MESHES = ["1,1,1", "2,1,1", "2,2,1", "2,2,2"]
# The longest one launch of ranks may take.
SPAWN_TIMEOUT_S = 900.0


def ladder() -> List[tuple]:
    return ([("MultiChipSuite", m) for m in SUITE_MESHES]
            + [("ICIBandwidth", m) for m in ICI_MESHES])


def ranks_of(mesh: str) -> int:
    return int(np.prod([int(p) for p in mesh.split(",")]))


def config(mesh: str):
    from gpuaudiobench_tpu_torch.config import BenchConfig

    return BenchConfig(buffer_size=256, n_tracks=32, n_runs=5, warmup=2,
                       transfer_mib=1, mesh=mesh, write_latencies=False,
                       device_timing=False, quiet=True)


def collectives(rec: Dict) -> str:
    inv = (rec.get("metadata") or {}).get("collectiveInventory") or []
    if not inv:
        return "—"
    return ", ".join(f"{c['kind']}({c['bytes'] / 1024:.0f}KiB/n={c['axis_n']})"
                     for c in inv)


def run(cases: List[tuple], device: str, n_dev: int) -> Dict:
    """Each (benchmark, mesh) of ``cases`` that the devices hold, the
    meshes of one rank count in one launch: (rows in ``cases``' order,
    skipped lines)."""
    from gpuaudiobench_tpu_torch.parallel import ranks
    from gpuaudiobench_tpu_torch.parallel.launch import spmd

    by_world: Dict[int, List[tuple]] = {}
    skipped = []
    for name, mesh in cases:
        n = ranks_of(mesh)
        if n > n_dev:
            skipped.append(f"{name} {mesh}: skipped, needs {n} devices; "
                           f"{n_dev} available")
            print(skipped[-1], flush=True)
            continue
        by_world.setdefault(n, []).append((name, mesh))
    recs = {}
    for n, group in sorted(by_world.items()):
        jobs = [(name, config(mesh)) for name, mesh in group]
        out = (ranks.json_runs(jobs, device) if n == 1 else
               spmd(ranks.json_runs, n, device, jobs, device,
                    timeout_s=SPAWN_TIMEOUT_S))
        recs.update(zip(group, out))
    rows = []
    for name, mesh in cases:
        rec = recs.get((name, mesh))
        if rec is None:
            continue
        rows.append({"benchmark": name, "mesh": mesh, "ranks": ranks_of(mesh),
                     "p50_ms": rec["statistics"]["p50_ms"],
                     "collectives": collectives(rec),
                     "inventory": (rec.get("metadata") or {}).get(
                         "collectiveInventory") or [],
                     "validation": validated(rec)})
        r = rows[-1]
        print(f"| {name} | {mesh} | {r['p50_ms']:.2f} | {r['collectives']} "
              f"| {r['validation']} |", flush=True)
    return {"rows": rows, "skipped": skipped}


def render_md(payload: Dict) -> str:
    gpu = payload["backend"] == "nccl"
    lines = [
        f"# Mesh scaling (multi-device layer) on {payload['card']}",
        "",
        f"{payload['devices']} device(s), {payload['backend']} ranks "
        "(parallel/launch.py:spmd). "
        + ("One rank a card; the p50 is the round trip of one block over "
           "the mesh." if gpu else
           "On gloo ranks on the CPU the p50 column is functional (the "
           "mesh partitions, communicates and validates); it does not "
           "measure an interconnect.")
        + " `collectives` lists what one step issued "
        "(metadata.collectiveInventory: kind, bytes, axis size).",
        "",
        "| Benchmark | mesh dp,tp,sp | p50 ms | collectives | validation |",
        "|---|---|---:|---|---|",
    ]
    for r in payload["rows"]:
        lines.append(f"| {r['benchmark']} | {r['mesh']} | {r['p50_ms']:.2f} "
                     f"| {r['collectives']} | {r['validation']} |")
    if payload["skipped"]:
        lines += [""] + [f"- {s}" for s in payload["skipped"]]
    lines += ["", f"All times in ms on {payload['card']}. Campaign: python -m "
              "gpuaudiobench_tpu_torch.tools.mesh_scaling."]
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="")
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from gpuaudiobench_tpu_torch.parallel.launch import BACKENDS
    from gpuaudiobench_tpu_torch.parallel.mesh import available_devices
    from gpuaudiobench_tpu_torch.utils import device as dv

    dev = dv.device(args.device)
    n_dev = available_devices(dev)
    payload = {"card": card(dev), "devices": n_dev,
               "backend": BACKENDS[args.device],
               **run(ladder(), args.device, n_dev)}
    paths = write_report(out_base(args.out, "mesh_scaling"), payload,
                         render_md(payload))
    print(f"written: {' / '.join(paths)}")
    return 0 if all(r["validation"] == "passed"
                    for r in payload["rows"]) else 1


if __name__ == "__main__":
    sys.exit(main())
