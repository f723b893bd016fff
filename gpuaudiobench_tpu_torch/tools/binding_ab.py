"""The binding's cost, A/B: the eight kernels that launch through the
``gpuab`` operators since queue 1's item 21b (they launched through
ctypes before), timed at ``chip_smoke.py``'s main shapes against another
checkout of the port.

For each kernel, through its wrapper in ``ops/*.py``:

* ``ms``: the CUDA-event time a call, the median over 20 reps of 10 calls
  back to back (as ``chip_smoke.py`` times its rows);
* ``host_us``: the wrapper's host time a call, 100 calls enqueued behind a
  ~50 ms ``torch.cuda._sleep`` spin (so the host never waits on the card),
  the median over 21 reps: the checks, the allocations and the launch,
  through a ctypes call or an operator's dispatch.

    python -m gpuaudiobench_tpu_torch.tools.binding_ab [--other DIR]
        [--out FILE]

With ``--other`` (the root of another checkout, e.g. a ``git archive`` of
the parent commit unpacked into a gitignored directory) it runs the
measurement in fresh processes in turns, other, this, this, other, each
importing its own checkout's package and building its own kernels, and
prints a table of both; without it, this checkout once. ``--out`` writes
the results as JSON. On the card only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
REPS, CALLS = 20, 10
HOST_REPS, HOST_CALLS = 21, 100
SPIN_CYCLES = 100_000_000  # ~50 ms at the H100's 1.98 GHz
KERNELS = ("modal_res", "iir_biquad_blockstate", "iir_cascade_chain",
           "rndmem_gather", "dwg_block", "fdtd3d_field", "fma_chain",
           "fma_vmem")


def _cases(torch, device) -> Dict[str, object]:
    """kernel -> a zero-argument call of its wrapper at chip_smoke.py's
    main shape (seeded inputs on the card)."""
    import numpy as np

    from gpuaudiobench_tpu_torch.ops import dwg, fdtd3d, iir, modal, rndmem
    from gpuaudiobench_tpu_torch.ops import speedoflight as sol
    from gpuaudiobench_tpu_torch.utils.data import biquad_lowpass_coefficients

    g = np.random.Generator(np.random.MT19937(11))
    f32 = np.float32

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def uniform(*shape, lo=-1.0, hi=1.0):
        return (lo + (hi - lo) * g.random(shape, dtype=f32)).astype(f32)

    m, s, t = 1048576, 512, 32  # the modal headline
    w = (f32(2 * np.pi) * g.random(m, dtype=f32) * f32(0.45)).astype(f32)
    amp = g.random(m, dtype=f32)
    re_f, im_f = amp * uniform(m), amp * uniform(m)
    res = modal.res_init(put(np.cos(w).astype(f32)),
                         put(np.sin(w).astype(f32)), put(re_f), put(im_f))

    tracks = 65536  # the IIR paths
    x = put(uniform(tracks, s))
    c1 = np.array(biquad_lowpass_coefficients(0.25), f32)
    taps, u = iir.blockstate_tables(c1, iir.blockstate_effective_m(s, 128))
    z1 = put(uniform(tracks, 2, lo=-0.5, hi=0.5))
    ck = put(np.array([biquad_lowpass_coefficients(0.25 - 0.0125 * i)
                       for i in range(10)], f32))
    zk = put(uniform(10, tracks, 2, lo=-0.1, hi=0.1))
    c1, taps, u = put(c1), put(taps), put(u)

    pool = put(g.random(512 * 1024 * 1024 // 4, dtype=f32))  # 512 MiB
    ph = put(g.integers(0, pool.shape[0] - s, 65536).astype(np.int32))

    guides, lmax = 32768, 2000  # DWG1DNaive's
    lengths = (100 + g.integers(0, lmax - 100, guides)).astype(np.int32)
    rails = [put(uniform(guides, lmax, lo=0.0, hi=0.1)) for _ in range(2)]
    dwg_params = [put(a) for a in (
        lengths, lengths // 4, 3 * lengths // 4,
        0.1 + 0.9 * g.random(guides, dtype=f32),
        (0.99 + 0.01 * (g.random(guides, dtype=f32) - 0.5)).astype(f32),
        (0.9999 + 1e-4 * (g.random(guides, dtype=f32) - 0.5)).astype(f32))]

    room, fdtd_tracks = 50, 128  # FDTD3D's field form, per-track receivers
    n = fdtd3d.grid_n(room)
    src, rcv = fdtd3d.source_pos(room), fdtd3d.receiver_pos(room)
    xs, ys, zs = fdtd3d.receiver_line(fdtd_tracks, n)
    cells = put(((xs.astype(np.int64) * n + ys) * n + zs).astype(np.int32))
    fields = fdtd3d.zero_fields(n, device)
    xf = put(uniform(fdtd_tracks, s))

    chain_x, vmem_x = put(uniform(2048, 1024)), put(uniform(512, 1024))

    return {
        "modal_res": lambda: modal.modal_res_step(*res, s, t),
        "iir_biquad_blockstate": lambda: iir.iir_biquad_blockstate(
            x, c1, taps, u, z1),
        "iir_cascade_chain": lambda: iir.iir_cascade_chain(x, ck, zk),
        "rndmem_gather": lambda: rndmem.rndmem_gather(pool, ph, s),
        "dwg_block": lambda: dwg.dwg_block(x[0], *rails, *dwg_params),
        "fdtd3d_field": lambda: fdtd3d.fdtd3d_block_field(
            xf, *fields, src, rcv, receivers=cells),
        "fma_chain": lambda: sol.fma_chain(chain_x, 512),
        "fma_vmem": lambda: sol.fma_vmem(vmem_x, 512),
    }


def _device_ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(CALLS):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / CALLS)
    return statistics.median(times)


def _host_us(torch, fn) -> float:
    times = []
    for _ in range(HOST_REPS):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        times.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def measure() -> Dict[str, Dict[str, float]]:
    """{kernel: {"ms", "host_us", "launches"}} of this process's package,
    on the card."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("binding_ab: CUDA requested but "
                           "torch.cuda.is_available() is False")
    from gpuaudiobench_tpu_torch.ops import (
        dwg,
        fdtd3d,
        iir,
        modal,
        rndmem,
        speedoflight,
    )

    device = torch.device("cuda")
    cases = _cases(torch, device)
    counts = {}
    for mod in (modal, iir, rndmem, dwg, fdtd3d, speedoflight):
        counts.update({k: (mod, k) for k in mod.KERNEL_LAUNCHES})
    out = {}
    for name in KERNELS:
        mod, key = counts[name]
        before = mod.KERNEL_LAUNCHES[key]
        ms = _device_ms(torch, cases[name])
        host = _host_us(torch, cases[name])
        out[name] = {"ms": ms, "host_us": host,
                     "launches": mod.KERNEL_LAUNCHES[key] - before}
        if out[name]["launches"] <= 0:
            raise RuntimeError(f"binding_ab: {name} launched no kernel")
    return out


def _worker(root: Path) -> Dict[str, Dict[str, float]]:
    """``measure`` in a fresh process that imports ``root``'s package."""
    code = ("import json, runpy, sys; sys.argv = ['binding_ab', '--worker']; "
            f"runpy.run_path({str(Path(__file__).resolve())!r}, "
            "run_name='__main__')")
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"binding_ab: the worker in {root} failed:\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="binding_ab", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--other", help="root of the checkout to compare with")
    ap.add_argument("--out", help="write the results as JSON here")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(measure()))
        return 0
    try:
        if args.other is None:
            runs = {"this": [_worker(ROOT)]}
        else:
            other = Path(args.other).resolve()
            runs = {"other": [], "this": []}
            for side in ("other", "this", "this", "other"):
                runs[side].append(_worker(other if side == "other" else ROOT))
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    card = _card()
    print(f"binding A/B on {card}: ms a call (CUDA events, back to back) "
          f"and host us a call (behind a spin), each run in turns")
    for name in KERNELS:
        cells = []
        for side, reps in runs.items():
            ms = " / ".join(f"{r[name]['ms']:.4f}" for r in reps)
            us = " / ".join(f"{r[name]['host_us']:.1f}" for r in reps)
            cells.append(f"{side} {ms} ms, {us} us")
        print(f"{name}: " + "; ".join(cells))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "runs": runs},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
