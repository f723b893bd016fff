"""Measure the blockstate kernel's redesign on one CUDA device.

    python3 tools/blockstate_stages/run.py [--out DIR]

Builds ``stages.cu`` (beside this file; it includes
``gpuaudiobench_tpu_torch/csrc/iir.cu``) with nvcc and prints, one line
each:

* the card (``nvidia-smi`` name, power limit, max SM clock) and toolchain;
* ``ptxas -v`` registers, spills and shared memory of the old kernel, the
  shipped kernel and the three stage kernels at m = 128;
* from ``cuobjdump -sass``, the instruction mix of the old kernel's inner
  loop and of the shipped kernel's item loop;
* blocks an SM (occupancy API) of the old and the shipped kernel;
* every kernel against ``iir_biquad_blockstate_plain`` over 3 chained
  blocks at 16 shapes (m from 2 to 128, ragged track counts), and whether
  two runs agree bit for bit;
* CUDA-event times at 65,536 x 512, m = 128, in turns (old, stage A,
  stage B's first form, shipped, shipped, ..., old), beside
  ``torch.matmul`` on the chunk products and a copy of the same bytes;
* clock64() phase sums per warp (microseconds at the max SM clock) of the
  instrumented kernels, with and without the copies;
* the tensor pipe's rate for independent HMMA.1688.F32.TF32 chains.

Needs one CUDA device, nvcc and cuobjdump (``$CUDA_HOME`` or
``/usr/local/cuda``). ``--out`` (default ``build/blockstate_stages``,
which git ignores) receives ptxas.txt and the SASS of the two kernels.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
from gpuaudiobench_tpu_torch.ops import iir as iops  # noqa: E402
from gpuaudiobench_tpu_torch.utils.build import NVCC_FLAGS, nvcc_path  # noqa: E402
from gpuaudiobench_tpu_torch.utils.data import biquad_lowpass_coefficients  # noqa: E402

FULL = (65536, 512, 128)
CASES = [FULL, (65536, 512, 16), (4096, 512, 128), (1000, 96, 12),
         (1000, 96, 128), (1000, 96, 16), (8, 64, 128), (640, 128, 16),
         (33, 14, 7), (8, 64, 2), (17, 30, 3), (40, 120, 5), (1000, 512, 128),
         (3, 510, 102), (5, 381, 127), (100, 248, 124)]
ATOL = 1e-5
NAMES = {"old": None, "stage A": 1, "stage B first form": 2,
         "shipped (instrumented copy)": 3, "shipped": None}
PHASES = ["prologue", "copy issue", "copy wait", "product + w", "y",
          "state", "total"]


def sh(cmd):
    p = subprocess.run(cmd, capture_output=True, text=True)
    return p.returncode, p.stdout + p.stderr


def hot_loops(sass: str, fn_pattern: str, key: str):
    """Opcode counts of each backward-branch loop of the function whose
    name matches ``fn_pattern``, densest in ``key`` first."""
    for block in re.split(r"\n\s+Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        if not re.search(fn_pattern, name):
            continue
        ins = []
        for ln in block.splitlines():
            m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", ln)
            if m:
                ins.append((int(m.group(1), 16), m.group(3), m.group(4)))
        loops = []
        for addr, op, rest in ins:
            t = re.search(r"BRA\S*\s+(?:`\(\S+\)\s*)?0x([0-9a-f]+)", op + rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
                start = int(t.group(1), 16)
                body = [o.split(".")[0] for a, o, _ in ins if start <= a <= addr]
                loops.append(collections.Counter(body))
        loops.sort(key=lambda c: -c[key] / sum(c.values()))
        return name, loops
    return None, []


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(REPO / "build" / "blockstate_stages"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
              "--format=csv,noheader"])[1].strip()
    print(f"card: {smi}")
    max_mhz = float(smi.split(",")[-1].split()[0])
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    lib_path = Path(tempfile.mkdtemp()) / "stages.so"
    t0 = time.time()
    rc, log = sh([nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib_path),
                  str(Path(__file__).with_name("stages.cu"))])
    (out / "ptxas.txt").write_text(log)
    print(f"build: rc {rc} in {time.time() - t0:.1f} s")
    if rc != 0:
        print(log[-4000:])
        return 1
    fn = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
        if fn and "Used" in ln and re.search(
                r"iir_blockstate_kernelILi16E|stage_kernelILi16E", fn):
            print(f"ptxas {fn}: {ln.split(':', 1)[1].strip()}")
        if fn and "spill" in ln and re.search(
                r"iir_blockstate_kernelILi16E|stage_kernelILi16E", fn):
            print(f"ptxas {fn}: {ln.strip()}")
    cuobjdump = str(Path(nvcc_path()).with_name("cuobjdump"))
    _, sass = sh([cuobjdump, "-sass", str(lib_path)])
    for label, pat, key in (("old", r"old_form.*iir_blockstate_kernelILi16E", "FFMA"),
                            ("shipped", r"^_ZN\S*_GLOBAL__N\S*iir_blockstate_kernelILi16E", "HMMA")):
        name, loops = hot_loops(sass, pat, key)
        blk = re.split(r"\n\s+Function : ", sass)
        for b in blk[1:]:
            if b.split("\n", 1)[0].strip() == name:
                (out / f"sass_{label}.txt").write_text(b)
        if loops:
            top = loops[0]
            print(f"sass {label} ({name}): densest {key} loop {sum(top.values())} "
                  f"instructions: " + ", ".join(f"{k} {v}" for k, v in top.most_common(10)))

    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.old_blockstate_launch.argtypes = [p] * 7 + [i] * 3 + [p]
    lib.iir_blockstate_launch.argtypes = [p] * 7 + [i] * 3 + [p]
    lib.stage_launch.argtypes = [p] * 7 + [i] * 5 + [p, ip, p]
    lib.old_blockstate_profile.argtypes = [p] * 7 + [i] * 2 + [p, p]
    lib.old_blockstate_occupancy.argtypes = [ip]
    lib.shipped_blockstate_occupancy.argtypes = [ip]
    lib.hmma_probe.argtypes = [p, i, i, i, p]
    for f in (lib.old_blockstate_launch, lib.old_blockstate_profile,
              lib.iir_blockstate_launch, lib.stage_launch,
              lib.old_blockstate_occupancy, lib.shipped_blockstate_occupancy,
              lib.hmma_probe):
        f.restype = i
    b = ctypes.c_int(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"occupancy: old {lib.old_blockstate_occupancy(ctypes.byref(b))} "
          f"blocks/SM of 256 threads at {b.value} B shared; shipped "
          f"{lib.shipped_blockstate_occupancy(ctypes.byref(b))} blocks/SM of "
          f"512 threads at {b.value} B; {sms} SMs")

    dev = torch.device("cuda:0")
    assert not torch.backends.cuda.matmul.allow_tf32
    grid = ctypes.c_int(0)

    def run(name, x, c, taps, u, z, product_only=0, prof=None):
        tracks, s = x.shape
        m = taps.shape[0]
        y = torch.empty_like(x)
        zo = torch.empty_like(z)
        st = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (x, c, taps, u, z, y, zo)]
        if name == "old":
            err = lib.old_blockstate_launch(*ptrs, tracks, s, m, st)
        elif name == "shipped":
            err = lib.iir_blockstate_launch(*ptrs, tracks, s, m, st)
        else:
            err = lib.stage_launch(*ptrs, tracks, s, m, NAMES[name], product_only,
                                   None if prof is None else prof.data_ptr(),
                                   ctypes.byref(grid), st)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return y, zo

    def inputs(tracks, s, block_m, seed=11):
        g = np.random.Generator(np.random.MT19937(seed))
        x = (g.random((tracks, s), dtype=np.float32) * 2 - 1).astype(np.float32)
        c = np.array(biquad_lowpass_coefficients(0.25), np.float32)
        z = (g.random((tracks, 2), dtype=np.float32) - 0.5).astype(np.float32)
        taps, u = iops.blockstate_tables(c, iops.blockstate_effective_m(s, block_m))
        return [torch.from_numpy(a).to(dev) for a in (x, c, taps, u, z)]

    ok = True
    for tracks, s, bm in CASES:
        x, c, taps, u, z = inputs(tracks, s, bm)
        line = f"check {tracks}x{s} m={taps.shape[0]}:"
        for name in NAMES:
            zk, zp, err = z, z, 0.0
            for _ in range(3):
                yk, zk = run(name, x, c, taps, u, zk)
                yp, zp = iops.iir_biquad_blockstate_plain(x, c, taps, u, zp)
                err = max(err, (yk - yp).abs().max().item(), (zk - zp).abs().max().item())
            y1, z1 = run(name, x, c, taps, u, z)
            y2, z2 = run(name, x, c, taps, u, z)
            det = torch.equal(y1, y2) and torch.equal(z1, z2)
            ok = ok and det and err <= ATOL
            line += f"  {name} {err:.3g}{'' if det else ' NOT deterministic'}"
        print(line)
    print(f"every kernel within {ATOL:g} of the twin and deterministic: {ok}")

    def median_ms(fn, reps=20, calls=10):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(calls):
                fn()
            e.record()
            e.synchronize()
            ts.append(a.elapsed_time(e) / calls)
        ts.sort()
        return ts[len(ts) // 2]

    x, c, taps, u, z = inputs(*FULL)
    times = collections.defaultdict(list)
    order = ["old", "stage A", "stage B first form", "shipped"]
    for name in order + order[::-1]:
        times[name].append(median_ms(lambda: run(name, x, c, taps, u, z)))
    chunks = x.reshape(-1, FULL[2])
    taps_t = taps.t().contiguous()
    times["torch.matmul chunk products"].append(
        median_ms(lambda: torch.matmul(chunks, taps_t)))
    times["copy of x (same bytes)"].append(median_ms(lambda: x.clone()))
    print(f"times {FULL[0]}x{FULL[1]} m={FULL[2]} (ms, CUDA events, median of "
          "20 x 10 calls):")
    for k, v in times.items():
        print(f"  {k}: " + " / ".join(f"{t:.4f}" for t in v))

    tracks, s_len, _ = FULL
    prof = torch.zeros(tracks // 32 * 8 * 8, dtype=torch.int64, device=dev)
    y = torch.empty_like(x)
    zo = torch.empty_like(z)
    err = lib.old_blockstate_profile(*[t.data_ptr() for t in (x, c, taps, u, z, y, zo)],
                                     tracks, s_len, prof.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"old_blockstate_profile: CUDA error {err}")
    pr = prof.view(-1, 8).cpu().numpy()[:, :7].astype(np.float64) / max_mhz
    names = ["prologue (taps, u, state)", "x load + barrier", "own product",
             "barrier after the product", "w + barrier", "y + barrier",
             "state + barrier"]
    per_warp = pr.reshape(-1, 8, 7)
    print(f"phases old kernel ({tracks // 32} blocks of 8 warps; mean us a block, "
          "summed over its chunks): " + ", ".join(
              f"{n} {per_warp[:, :, q].mean():.2f}" for q, n in enumerate(names))
          + f"; total {per_warp.sum(axis=2).mean():.2f}; own product by warp "
          + " / ".join(f"{per_warp[:, w, 2].mean():.2f}" for w in range(8)))

    for name in ("stage A", "stage B first form", "shipped (instrumented copy)"):
        for product_only in (0, 1):
            prof = torch.zeros(sms * 16 * 8, dtype=torch.int64, device=dev)
            run(name, x, c, taps, u, z, product_only, prof)
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            a.record()
            run(name, x, c, taps, u, z, product_only, prof)
            e.record()
            torch.cuda.synchronize()
            warps = grid.value * (16 if name.startswith("shipped") else 8)
            pr = prof.view(-1, 8)[:warps].cpu().numpy().astype(np.float64)
            us = pr[:, :7] / max_mhz
            print(f"phases {name}{', product only' if product_only else ''} "
                  f"({a.elapsed_time(e):.4f} ms, {grid.value} blocks, "
                  f"{pr[:, 7].mean():.2f} items a warp; mean us a warp): "
                  + ", ".join(f"{n} {us[:, q].mean():.2f}" for q, n in enumerate(PHASES)))

    buf = torch.zeros(1024, device=dev)
    for warps in (4, 8, 16):
        iters = 4096

        def probe():
            lib.hmma_probe(buf.data_ptr(), sms, 32 * warps, iters,
                           torch.cuda.current_stream().cuda_stream)

        ms = median_ms(probe, reps=5, calls=3)
        hmma = sms * warps * iters * 8
        cycles = ms * 1e-3 * max_mhz * 1e6
        print(f"hmma probe, {warps} warps/SM of 8 independent chains: {ms:.4f} ms, "
              f"{cycles / (hmma / (sms * 4)):.2f} cycles per HMMA.1688.F32.TF32 per "
              f"SM sub-partition, {hmma * 2048 / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
    print(f"card: {sh(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'])[1].strip()}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
