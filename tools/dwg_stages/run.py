"""Measure the DWG block kernels' redesign on one CUDA device.

    python3 tools/dwg_stages/run.py [--out DIR]

Builds ``stages.cu`` (beside this file; it includes
``gpuaudiobench_tpu_torch/csrc/dwg.cu`` and holds the kernel pair as it
shipped before) with nvcc and prints, one line each:

* the card (``nvidia-smi`` name, power limit, max SM clock) and toolchain;
* ``ptxas -v`` registers, spills and shared memory of the old pair, the
  block kernel at 8 pairs a thread (shipped) and at 1, 2, 4 and 16, the fold
  kernels and the variants' kernels (``stages.cu`` lists them);
* blocks an SM of each (occupancy API) and the waves the main shape takes;
* at every shape of ``chip_smoke.DWG_SHAPES`` (edge lengths 1, 2, S - 1,
  S, S + 1, 2S - 1, odd, in tap = out tap, out tap >= S, at S = 48, 512
  and 2,000; the main 32,768 x 512 x Lmax 2,000 with random and
  power-of-two lengths; 70,000 waveguides), with ``chip_smoke.dwg_inputs``
  (rails U(0, 0.1)) chained over 2 blocks: the shipped
  pair's rails and mono output against the old pair's bit for bit, its
  mono output against ``ops.dwg.dwg_mono_in_order`` bit for bit, a rerun
  bit for bit, and the variants (1, 2, 4, 16 pairs a thread; a narrow
  fold kernel, in an ordinary or a programmatic dependent launch; the
  sums in the old layout; the last-block fold) against the old pair bit
  for bit;
* CUDA-event times at the main shape (random lengths) in turns: old,
  shipped, the variants, the update blocks alone, the mono blocks alone,
  each fold kernel alone, a copy of the bytes (``torch.Tensor.copy_``
  of half the pair's bytes each way), shipped, old; and old / shipped /
  shipped / old at power-of-two lengths. Each rep of 10 calls starts
  behind a ~2 ms spin (``torch.cuda._sleep``), so the events time the
  device alone, not the host's launch path (``chip_smoke.py`` times the
  shipped pair back to back, as it times every kernel);
* the host time of one ``ops.dwg.dwg_block`` call (50 calls enqueued
  behind a spin).

Needs one CUDA device and nvcc (``$CUDA_HOME`` or ``/usr/local/cuda``).
``--out`` (default ``build/dwg_stages``, which git ignores) receives
ptxas.txt.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import DWG_FULL as FULL  # noqa: E402
from chip_smoke import DWG_SHAPES as SHAPES  # noqa: E402
from chip_smoke import dwg_inputs  # noqa: E402
from gpuaudiobench_tpu_torch.models.dwg import dwg_cost  # noqa: E402
from gpuaudiobench_tpu_torch.ops import dwg as dops  # noqa: E402
from gpuaudiobench_tpu_torch.utils.build import NVCC_FLAGS, nvcc_path  # noqa: E402

PAIRS = (1, 2, 4, 8, 16)
SPIN_CYCLES = 4_000_000  # ~2 ms at 1.98 GHz: the host queues a rep meanwhile


def sh(cmd):
    p = subprocess.run(cmd, capture_output=True, text=True)
    return p.returncode, p.stdout + p.stderr


def inputs(g_count, s, lmax, lengths, pow2, same_tap, dev):
    return dwg_inputs(torch, g_count, s, lmax, lengths, pow2, dev,
                      same_tap=same_tap)


def schedule(g_count, s, lmax, pairs):
    """dwg_schedule's geometry at ``pairs`` pairs a thread."""
    sc = dops.dwg_schedule(g_count, s, lmax)
    segs = -(-min(lmax, s) // (32 * pairs))
    return dataclasses.replace(sc, segments=segs,
                               update_blocks=-(-g_count * segs // dops.DWG_WARPS))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(REPO / "build" / "dwg_stages"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
              "--format=csv,noheader"])[1].strip()
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.time()
    lib_path = Path(tempfile.mkdtemp()) / "dwg_stages.so"
    rc, log = sh([nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib_path),
                  str(HERE / "stages.cu")])
    (out_dir / "ptxas.txt").write_text(log)
    if rc != 0:
        print(log[-6000:])
        print("nvcc failed")
        return 1
    print(f"build: {time.time() - t0:.1f} s")
    fn = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
        if fn and ("Used" in ln or "spill" in ln):
            label = ("old update" if "old_form" in fn and "block" in fn else
                     "old sum" if "old_form" in fn else
                     "old layout" if "old_layout" in fn else
                     "last block" if "last_block" in fn else
                     "narrow fold kernel" if "narrow_fold" in fn else
                     "fold kernel" if "dwg_fold" in fn else
                     "pdl block kernel" if "pdl_block" in fn else
                     f"block kernel pairs {re.search(r'ILi(\d+)E', fn).group(1)}"
                     if "dwg_block_kernel" in fn else fn)
            print(f"ptxas {label}: {ln.split(':', 1)[-1].strip()}")

    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, argt in {"old_dwg_block_launch": [p] * 11 + [i] * 3 + [p],
                       "old_dwg_blocks": [i],
                       "dwg_block_launch": [p] * 11 + [i] * 6 + [p],
                       "pairs_launch": [p] * 11 + [i] * 7 + [p],
                       "two_kernel_launch": [p] * 11 + [i] * 7 + [p],
                       "last_block_launch": [p] * 12 + [i] * 6 + [p],
                       "update_only_launch": [p] * 9 + [i] * 6 + [p],
                       "mono_only_launch": [p] * 10 + [i] * 5 + [p],
                       "fold_only_launch": [i, p, p, i, i, p],
                       "stage_occupancy": [i, i]}.items():
        getattr(lib, name).argtypes = argt
        getattr(lib, name).restype = i
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g_full, s_full, lmax_full = FULL
    occ = {"old update": lib.stage_occupancy(0, 0), "old sum": lib.stage_occupancy(1, 0),
           "fold kernel": lib.stage_occupancy(3, 0),
           "narrow fold kernel": lib.stage_occupancy(4, 0),
           "last block": lib.stage_occupancy(5, 0)}
    for pairs in PAIRS:
        occ[f"block kernel pairs {pairs}"] = lib.stage_occupancy(2, pairs)
    old_blocks = lib.old_dwg_blocks(g_full)
    waves = {"old update": old_blocks / max(occ["old update"] * sms, 1)}
    for pairs in PAIRS:
        sc = schedule(g_full, s_full, lmax_full, pairs)
        waves[f"block kernel pairs {pairs}"] = (
            sc.grid / max(occ[f"block kernel pairs {pairs}"] * sms, 1))
    print("occupancy (blocks/SM; waves at the main shape): " + ", ".join(
        f"{k} {v}" + (f" ({waves[k]:.2f})" if k in waves else "") for k, v in occ.items()))

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def ck(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: CUDA error {err}")

    def ptrs(a):
        return [t.data_ptr() for t in a]

    def old(a):
        x, fwd = a[0], a[1]
        g_count, lmax = fwd.shape
        part = torch.empty((x.shape[0], lib.old_dwg_blocks(g_count)), device=x.device)
        out = torch.empty_like(x)
        ck(lib.old_dwg_block_launch(*ptrs(a), part.data_ptr(), out.data_ptr(), g_count,
                                    lmax, x.shape[0], stream()), "old")
        return out

    done = torch.zeros(1, dtype=torch.int32, device="cuda")

    def shipped(a, pairs=None):
        x, fwd = a[0], a[1]
        g_count, lmax = fwd.shape
        s = x.shape[0]
        sc = (dops.dwg_schedule(g_count, s, lmax) if pairs is None
              else schedule(g_count, s, lmax, pairs))
        gs = torch.empty((sc.groups, s), device=x.device)
        out = torch.empty_like(x)
        if pairs is None:
            ck(lib.dwg_block_launch(*ptrs(a), gs.data_ptr(), out.data_ptr(), g_count, lmax,
                                    s, sc.segments, sc.groups, sc.update_blocks, stream()),
               "shipped")
        else:
            ck(lib.pairs_launch(*ptrs(a), gs.data_ptr(), out.data_ptr(), g_count, lmax, s,
                                pairs, sc.segments, sc.groups, sc.update_blocks, stream()),
               f"pairs {pairs}")
        return out

    def two_kernels(a, fold):
        x, fwd = a[0], a[1]
        g_count, lmax = fwd.shape
        s = x.shape[0]
        sc = schedule(g_count, s, lmax, 8)
        sums = torch.empty((sc.groups, s), device=x.device)
        out = torch.empty_like(x)
        ck(lib.two_kernel_launch(*ptrs(a), sums.data_ptr(), out.data_ptr(), g_count, lmax,
                                 s, sc.segments, sc.groups, sc.update_blocks, fold,
                                 stream()), "two kernels")
        return out

    def last_block(a):
        x, fwd = a[0], a[1]
        g_count, lmax = fwd.shape
        s = x.shape[0]
        sc = schedule(g_count, s, lmax, 8)
        gs = torch.empty((sc.groups, s), device=x.device)
        out = torch.empty_like(x)
        ck(lib.last_block_launch(*ptrs(a), gs.data_ptr(), out.data_ptr(), done.data_ptr(),
                                 g_count, lmax, s, sc.segments, sc.groups, sc.update_blocks,
                                 stream()), "last block")
        return out

    def update_only(a, pairs):
        x, fwd = a[0], a[1]
        g_count, lmax = fwd.shape
        sc = schedule(g_count, x.shape[0], lmax, pairs)
        ck(lib.update_only_launch(*ptrs(a), g_count, lmax, x.shape[0], pairs, sc.segments,
                                  sc.update_blocks, stream()), "update only")

    def mono_only(a):
        x, fwd = a[0], a[1]
        g_count, lmax = fwd.shape
        s = x.shape[0]
        sc = schedule(g_count, s, lmax, 8)
        gs = torch.empty((sc.groups, s), device=x.device)
        ck(lib.mono_only_launch(*ptrs(a), gs.data_ptr(), g_count, lmax, s, sc.segments,
                                sc.groups, stream()), "mono only")

    def fold_only(which, gs, out):
        ck(lib.fold_only_launch(which, gs.data_ptr(), out.data_ptr(), gs.shape[0],
                                out.shape[0], stream()), "fold only")

    variants = {"pairs 1": lambda a: shipped(a, 1), "pairs 2": lambda a: shipped(a, 2),
                "pairs 4": lambda a: shipped(a, 4), "pairs 16": lambda a: shipped(a, 16),
                "narrow fold": lambda a: two_kernels(a, 0),
                "narrow fold, dependent launch": lambda a: two_kernels(a, 1),
                "old layout": lambda a: two_kernels(a, 2),
                "last-block fold": last_block}

    def chained(fn, a, blocks=2):
        """Outputs and rails over ``blocks`` chained blocks from clones of
        a's rails; also the rails each block started from."""
        a = list(a)
        a[1], a[2] = a[1].clone(), a[2].clone()
        res = []
        for _ in range(blocks):
            start = (a[1].clone(), a[2].clone())
            out = fn(a)
            res.append((out, a[1].clone(), a[2].clone(), start))
        return res

    def same(r1, r2):
        return all(torch.equal(u, v) for b1, b2 in zip(r1, r2) for u, v in zip(b1[:3], b2[:3]))

    dev = torch.device("cuda:0")
    ok = True
    for shape in SHAPES:
        g_count, s, lmax, lengths, pow2, same_tap = shape
        a = inputs(g_count, s, lmax, lengths, pow2, same_tap, dev)
        ro, rn, rn2 = chained(old, a), chained(shipped, a), chained(shipped, a)
        bit, det = same(ro, rn), same(rn, rn2)
        emu = True
        host = [t.cpu().numpy() for t in a]
        for out, _, _, (f0, b0) in rn:
            want = dops.dwg_mono_in_order(host[0], f0.cpu().numpy(), b0.cpu().numpy(),
                                          *host[3:])
            emu = emu and np.array_equal(out.cpu().numpy(), want)
        var = "".join("=" if same(ro, chained(v, a)) else "x" for v in variants.values())
        peak = max(r[0].abs().max().item() for r in ro)
        ok = ok and bit and det and emu and var == "=" * len(variants)
        sc = dops.dwg_schedule(g_count, s, lmax)
        print(f"check G={g_count} S={s} Lmax={lmax}{' pow2' if pow2 else ''}"
              f"{' edge' if lengths is not None else ''}: old {'=' if bit else 'DIFFERS'}, "
              f"emulated order {'=' if emu else 'DIFFERS'}, rerun "
              f"{'=' if det else 'DIFFERS'}, variants {var} ({', '.join(variants)}); "
              f"out peak {peak:.4g}; schedule segments {sc.segments} groups "
              f"{sc.groups} grid {sc.grid}")
    print(f"all shapes bit for bit (old pair, emulated order, rerun, variants): {ok}")

    def median_ms(fn, reps=20, calls=10):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            e0.record()
            for _ in range(calls):
                fn()
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1) / calls)
        return sorted(ts)[len(ts) // 2]

    for pow2 in (False, True):
        a = inputs(*FULL, None, pow2, False, dev)
        touched = int(torch.clamp(a[3], max=s_full).sum().item())
        cost = dwg_cost(g_full, s_full, touched)
        half = cost["hbm_bytes"] // 8  # floats: half the bytes each way
        src = torch.empty(half, device=dev)
        dst = torch.empty_like(src)
        groups = dops.dwg_schedule(*FULL).groups
        gs, out = torch.rand((groups, s_full), device=dev), torch.empty(s_full, device=dev)
        order = ["old", "shipped"]
        if not pow2:
            order += list(variants) + ["update blocks alone (pairs 8)",
                                       "update blocks alone (pairs 4)",
                                       "mono blocks alone", "fold kernel alone",
                                       "narrow fold kernel alone", "copy of the bytes"]
        order += ["shipped", "old"]
        funcs = dict(variants, old=old, shipped=shipped)
        funcs["update blocks alone (pairs 8)"] = lambda a: update_only(a, 8)
        funcs["update blocks alone (pairs 4)"] = lambda a: update_only(a, 4)
        funcs["mono blocks alone"] = mono_only
        funcs["fold kernel alone"] = lambda a: fold_only(0, gs, out)
        funcs["narrow fold kernel alone"] = lambda a: fold_only(1, gs, out)
        times = {}
        for name in order:
            if name == "copy of the bytes":
                f = lambda: dst.copy_(src)  # noqa: E731
            else:
                f = (lambda fn: lambda: fn(a))(funcs[name])
            times.setdefault(name, []).append(median_ms(f))
        print(f"times {g_full}x{s_full} Lmax {lmax_full}{' pow2' if pow2 else ''} "
              f"({touched} pairs, {cost['hbm_bytes']} B; ms, CUDA events behind a spin, "
              "median of 20 x 10 calls): " + "; ".join(f"{n} " + " / ".join(f"{v:.4f}" for v in vs)
                                     for n, vs in times.items()))
    # The wrapper's host path: calls enqueued behind a long spin, so none
    # waits for the card.
    a = inputs(*FULL, None, False, False, dev)
    for _ in range(3):
        dops.dwg_block(*a)
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        torch.cuda._sleep(200_000_000)
        t = time.perf_counter()
        for _ in range(50):
            dops.dwg_block(*a)
        host.append((time.perf_counter() - t) / 50 * 1e6)
        torch.cuda.synchronize()
    print("host time of one ops.dwg.dwg_block call (us, 50 calls behind a spin, 5 reps): "
          + " / ".join(f"{h:.1f}" for h in host))
    print(f"card: {sh(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'])[1].strip()}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
