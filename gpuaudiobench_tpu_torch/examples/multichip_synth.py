"""Scale the bell across a mesh of ranks: mode-sharded modal synthesis.

The port's copy of the repo-level ``examples/multichip_synth.py``. The
single-device example (``examples/streaming_synth.py``) streams a
2048-mode bell; this one shards the MODE axis of the same bank over the
ranks of a one-axis ("tp") mesh (``parallel/mesh.py``) and sums each
block's partial output across the mesh -- the pattern MultiChipSuite
benchmarks, here as plain user-facing API:

  * rank r holds modes [r*M/n, (r+1)*M/n) as amp-prefolded phasors; the
    mode state never leaves its rank,
  * per block every rank rotates only its own modes with the port's
    rotation kernel (``ops.modal.modal_folded_step``, the plain twin on
    a CPU rank) and contributes a partial (S,) buffer,
  * one ``psum`` over "tp" a block (``parallel/collectives.py``; S
    floats, the OUTPUT, not the mode state).

The ranks run under ``parallel.launch.spmd``: NCCL with rank r on
``cuda:r``, or gloo on the CPU (``--device cpu``). The collectives the
ranks issued are printed from ``parallel.collectives.COLLECTIVES``; a
one-rank mesh communicates nothing.

  python -m gpuaudiobench_tpu_torch.examples.multichip_synth \
      --ranks 4 --device cpu --seconds 2 --out bell4.wav

The render is checked against a one-rank render of the same bank on
rank 0's device (within 1e-6 of its peak: the psum changes the float32
summation order, so it is not bit for bit).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from gpuaudiobench_tpu_torch.examples.streaming_synth import (
    BLOCK,
    FS,
    bell_modes,
    write_wav,
)

SPMD_TIMEOUT_S = 600.0
REL_TOL = 1e-6


def _blocks(cos_w, sin_w, re, im, n: int, psum=None) -> torch.Tensor:
    from gpuaudiobench_tpu_torch.ops.modal import modal_folded_step

    out = []
    for _ in range(n):
        blk, re, im = modal_folded_step(cos_w, sin_w, re, im, BLOCK, 1)
        part = blk[:, 0]
        out.append(part if psum is None else psum(part))
    return torch.cat(out)


def rank_render(modes: int, n_blocks: int, device: str) -> Dict:
    """One rank's share of the render (run by ``spmd`` on every rank):
    its modes through the kernel, one psum a block. Rank 0 first renders
    the whole bank on its own device, the one-rank reference, and
    returns both with the collectives it issued and the kernel launches
    of all ranks (the reference's included)."""
    import torch.distributed as dist

    from gpuaudiobench_tpu_torch.ops import modal
    from gpuaudiobench_tpu_torch.parallel import collectives as col
    from gpuaudiobench_tpu_torch.parallel.launch import rank_device
    from gpuaudiobench_tpu_torch.parallel.mesh import build_mesh

    dev = rank_device(device)
    world = dist.get_world_size()
    mesh = build_mesh((world,), ("tp",), dev, "--ranks")
    amp, cos_w, sin_w, re0, im0 = bell_modes(modes)
    tables = [amp * re0, amp * im0, cos_w, sin_w]
    col.COLLECTIVES.clear()
    modal.KERNEL_LAUNCHES["modal_bank"] = 0
    out = {"world": world, "device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu"}
    if mesh.axis_index("tp") == 0:
        re, im, cos_d, sin_d = (torch.from_numpy(a).to(dev) for a in tables)
        out["golden"] = _blocks(cos_d, sin_d, re, im, n_blocks).cpu().numpy()
    lo = mesh.axis_index("tp") * modes // world
    hi = lo + modes // world
    re, im, cos_d, sin_d = (torch.from_numpy(a[lo:hi]).to(dev)
                            for a in tables)
    audio = _blocks(cos_d, sin_d, re, im, n_blocks,
                    psum=lambda x: col.psum(x, mesh, "tp"))
    out["audio"] = audio.cpu().numpy()
    out["collectives"] = list(col.COLLECTIVES)
    launches = torch.tensor([modal.KERNEL_LAUNCHES["modal_bank"]])
    if world > 1:
        dist.all_reduce(launches)
    out["launches"] = int(launches.item())
    return out


def render(modes: int, n_blocks: int, ranks: int, device: str) -> Dict:
    """``rank_render`` on a mesh of ``ranks`` ranks; rank 0's result."""
    from gpuaudiobench_tpu_torch.examples import multichip_synth
    from gpuaudiobench_tpu_torch.parallel.launch import spmd

    # By its package name, so the spawned ranks import this module.
    return spmd(multichip_synth.rank_render, ranks, device, modes,
                n_blocks, device, timeout_s=SPMD_TIMEOUT_S)


def collectives_line(issued: List[Dict], world: int) -> str:
    if not issued:
        return f"collectives issued: none ({world} rank, nothing to sum)"
    kinds = sorted({(c["kind"], c["axis"], c["axis_n"]) for c in issued})
    total = sum(c["bytes"] for c in issued)
    what = ", ".join(f"{k} over {a} ({n} ranks)" for k, a, n in kinds)
    return (f"collectives issued: {len(issued)} ({what}), {total} bytes, "
            f"{total // len(issued)} a block")


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--modes", type=int, default=4096)
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks of the mesh (default: every CUDA device, "
                         "or 1 on the CPU)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "bell_mesh.wav"))
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False")
    ranks = args.ranks or (torch.cuda.device_count()
                           if args.device == "cuda" else 1)
    if ranks < 1 or args.modes % ranks:
        print(f"--modes {args.modes} must divide by {ranks} ranks")
        return 1
    n_blocks = max(1, int(args.seconds * FS / BLOCK))
    res = render(args.modes, n_blocks, ranks, args.device)
    audio, golden = res["audio"], res["golden"]
    scale = float(np.abs(golden).max()) or 1.0
    max_rel = float(np.abs(audio - golden).max()) / scale
    ok = max_rel <= REL_TOL

    write_wav(args.out, audio)
    print(f"wrote {args.out}: {len(audio) / FS:.2f} s, {args.modes} modes "
          f"sharded over {res['world']} rank(s) [mesh axis tp] on "
          f"{res['device']}")
    print(f"matches one-rank render: {ok} "
          f"(max rel err {max_rel:.2e} vs peak)")
    print(collectives_line(res["collectives"], res["world"]))
    print(f"kernel launches: modal_bank {res['launches']} (all ranks)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
