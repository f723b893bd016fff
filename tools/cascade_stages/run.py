"""Measure the two biquad cascade kernels' redesigns on one CUDA device.

    python3 tools/cascade_stages/run.py [--part all|systolic|chain] [--out DIR]

The chain part alone takes ~2 minutes on an H100, the build included.

Builds ``stages.cu`` (beside this file; it includes
``gpuaudiobench_tpu_torch/csrc/iir.cu``) twice with nvcc, plain and with
``-DCASCADE_PROFILE``, one nvcc each, started together, and prints the
card (``nvidia-smi`` name, power limit, max SM clock) and toolchain,
then one line each for the part asked for (both by default).

``--part systolic``, the systolic cascade:

* ``ptxas -v`` registers, spills and shared memory of the old kernel at
  K = 1, 10, 16 and of the shipped kernel at every K;
* blocks an SM (occupancy API) of both, and the waves 65,536 tracks take;
* from ``cuobjdump -sass``, the instruction mix of the old kernel's step
  loop and of the shipped kernel's steady loop at K = 10, and
  instructions a stage-step;
* at every tool shape (K in {1, 2, 10, 16}, S in {1, 4, 7, 96, 512,
  521}, tracks in {1, 33, 1,000, 65,536}), states chained over 2 blocks:
  the shipped kernel's outputs and states against the old kernel's bit
  for bit, two runs of it against each other bit for bit, at K = 10 the
  variants against the old kernel bit for bit, and at 33 and 1,000
  tracks every kernel against ``iir_cascade_plain`` (1e-5 absolute);
* CUDA-event times at 65,536 x 512, K = 10, in turns (old, shipped,
  variants, shipped, old), beside a plain copy of the same bytes; and
  old / shipped / shipped / old at 128 tracks;
* clock64() phase sums per warp (microseconds at the max SM clock) of the
  old kernel and of the shipped kernel (the profiled build) at 65,536 x
  512, K = 10.

``--part chain``, the per-sample chain cascade (the systolic kernel's
oracle):

* ``ptxas -v`` of the old chain kernel and of the shipped kernel on both
  routes (TMA, staged) at K = 1, 10, 16, and of its two variants at
  K = 10 (the coefficients in registers instead of the constant bank;
  one tile a warp instead of the ring);
* blocks an SM (occupancy API) of the old kernel and of both routes, and
  the waves 65,536 tracks take;
* from ``cuobjdump -sass``, the densest FFMA loop of the old kernel and
  of both routes at K = 10: instructions a stage-sample and its MOVs;
* at every tool shape (as above), and at every K from 1 to 16 at 1,000
  x 96 and 33 x 521, states chained over 2 blocks: the
  shipped kernel on the route ``ops.iir.chain_schedule`` picks, bit for
  bit the old kernel's outputs and states, two runs of it bit for bit,
  the staged route forced where the rule picks TMA bit for bit too, at
  K = 10 the variants (and the kernel's copies alone, y = x), at 1,000
  tracks an unaligned x (staged by the
  rule), and at 33 and 1,000 tracks old and new against
  ``iir_cascade_plain`` (1e-5 absolute);
* CUDA-event times at 65,536 x 512, K = 10, behind a ~1 ms spin, in
  turns (old, shipped, the variants, the staged route, the shipped
  kernel's TMA copies alone with no stages, a copy of the same bytes,
  shipped, old), and the shipped kernel's share of its bytes
  bound at the data sheet's 3.35 TB/s and the measured peak
  (``utils/measured_peaks.json``);
* clock64() phase sums per warp (copy wait, stages, store) of the
  shipped kernel (the profiled build) at 65,536 x 512, K = 10.

Needs one CUDA device, nvcc and cuobjdump (``$CUDA_HOME`` or
``/usr/local/cuda``). ``--out`` (default ``build/cascade_stages``, which
git ignores) receives ptxas.txt and the SASS of the K = 10 kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
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
from gpuaudiobench_tpu_torch.harness.device_timing import spin_cycles_per_ms  # noqa: E402
from gpuaudiobench_tpu_torch.ops import iir as iops  # noqa: E402
from gpuaudiobench_tpu_torch.utils.build import NVCC_FLAGS, nvcc_path  # noqa: E402
from gpuaudiobench_tpu_torch.utils.data import biquad_lowpass_coefficients  # noqa: E402

FULL = (65536, 512, 10)
KS = (1, 2, 10, 16)
SS = (1, 4, 7, 96, 512, 521)
TRACKS = (1, 33, 1000, 65536)
TWIN_TRACKS = (33, 1000)
ATOL = 1e-5
# (warps a block, ring depth, steady quads a pass); shipped (4, 3, 1).
VARIANTS = {"(4, 4, 1)": 0, "(8, 3, 1)": 1, "(2, 3, 1)": 2, "(4, 3, 2)": 3}
OLD_PHASES = ["state loads", "tile loads", "barriers", "steps", "tile stores",
              "state stores"]
NEW_PHASES = {1: "prologue", 2: "copy wait", 3: "steady steps",
              4: "masked steps", 5: "tile stores + copies", 7: "state stores"}
# The chain kernel's variants at K = 10 on the TMA route (chain_variant_launch).
CHAIN_VARIANTS = {"no constant bank": 0, "no ring": 1}
CHAIN_COPY = 2  # its copies alone: the TMA ring with no stages, y = x
CHAIN_PHASES = {1: "prologue", 2: "copy wait", 3: "stages", 4: "store",
                7: "state stores"}


def sh(cmd):
    p = subprocess.run(cmd, capture_output=True, text=True)
    return p.returncode, p.stdout + p.stderr


def hot_loops(sass, fn_pattern, key):
    spec = importlib.util.spec_from_file_location(
        "blockstate_stages_run", HERE.parent / "blockstate_stages" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.hot_loops(sass, fn_pattern, key)


def build(out: Path):
    """Both libraries, one nvcc each, started together."""
    tmp = Path(tempfile.mkdtemp())
    src = str(HERE / "stages.cu")
    jobs = {}
    for name, extra in (("plain", []), ("prof", ["-DCASCADE_PROFILE"])):
        lib = tmp / f"stages_{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, *extra, "-Xptxas", "-v", "-o", str(lib), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    for name, (lib, proc) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            print(logs[name][-6000:])
            raise SystemExit(f"nvcc failed for the {name} build")
    (out / "ptxas.txt").write_text(logs["plain"])
    return jobs["plain"][0], jobs["prof"][0], logs["plain"]


def bind(path):
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    sig = {
        "old_cascade_launch": [p] * 5 + [i] * 3 + [p],
        "old_cascade_profile": [p] * 5 + [i] * 2 + [p, p],
        "old_cascade_occupancy": [i], "new_cascade_occupancy": [i],
        "variant_launch": [i] + [p] * 5 + [i] * 2 + [p],
        "iir_cascade_launch": [p] * 5 + [i] * 7 + [p], "iir_cascade_warps": [],
        "old_chain_launch": [p] * 5 + [i] * 3 + [p], "chain_occupancy": [i, i],
        "chain_variant_launch": [i] + [p] * 5 + [i] * 2 + [p],
        "iir_cascade_chain_launch": [p] * 5 + [i] * 6 + [p],
    }
    for fn, args in sig.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = i
    return lib


def ck(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def inputs(tracks, s, k, dev, seed=11):
    """Seeded x in [-1, 1), K staggered lowpasses, small nonzero states
    (chip_smoke.py's IIR inputs)."""
    g = np.random.Generator(np.random.MT19937(seed))
    x = (g.random((tracks, s), dtype=np.float32) * 2 - 1).astype(np.float32)
    c = np.array([biquad_lowpass_coefficients(0.25 - 0.0125 * i) for i in range(k)],
                 np.float32)
    z = ((g.random((k, tracks, 2), dtype=np.float32) - 0.5) * 0.2).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, c, z)]


def systolic_part(lib, plib, log, sass, out_dir, max_mhz) -> bool:
    """The systolic cascade: ptxas, SASS, occupancy, bit-for-bit checks,
    times and phases (the module docstring's first list)."""
    fn = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
        if not fn or not ("Used" in ln or "spill" in ln):
            continue
        old = re.search(r"old_form27iir_cascade_systolic_kernelILi(\d+)ELb0E", fn)
        new = re.search(r"iir_cascade_systolic_kernelILi(\d+)ELi4ELi3ELi1E", fn)
        if "old_form" not in fn and new:
            print(f"ptxas shipped K={new.group(1)}: {ln.split(':', 1)[-1].strip()}")
        elif old and old.group(1) in ("1", "10", "16"):
            print(f"ptxas old K={old.group(1)}: {ln.split(':', 1)[-1].strip()}")
        elif re.search(r"ILi10ELi(8|2|4)ELi(3|4)ELi(1|2)E", fn) and "old_form" not in fn:
            print(f"ptxas variant {fn[-40:]}: {ln.split(':', 1)[-1].strip()}")
    for label, pat in (("old", r"old_form27iir_cascade_systolic_kernelILi10ELb0E"),
                       ("shipped", r"^(?!.*old_form).*iir_cascade_systolic_kernelILi10ELi4ELi3ELi1E")):
        name, loops = hot_loops(sass, pat, "FFMA")
        for blk in re.split(r"\n\s+Function : ", sass)[1:]:
            if blk.split("\n", 1)[0].strip() == name:
                (out_dir / f"sass_{label}.txt").write_text(blk)
        if loops:
            top = loops[0]
            stage_steps = (top["FFMA"] + top["FMUL"]) / 5
            print(f"sass {label} K=10 ({name}): densest FFMA loop {sum(top.values())} "
                  f"instructions, {stage_steps:g} stage-steps, "
                  f"{sum(top.values()) / max(stage_steps, 1):.2f} a stage-step: "
                  + ", ".join(f"{k} {v}" for k, v in top.most_common(16)))

    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warps = lib.iir_cascade_warps()
    for k in (1, 10, 16):
        o_sm, n_sm = lib.old_cascade_occupancy(k), lib.new_cascade_occupancy(k)
        print(f"occupancy K={k}: old {o_sm} blocks/SM of 128 threads (512 blocks = "
              f"{512 / max(o_sm * sms, 1):.2f} waves); shipped {n_sm} blocks/SM of "
              f"{warps} warps ({65536 // (32 * warps)} blocks = "
              f"{65536 / (32 * warps) / max(n_sm * sms, 1):.2f} waves)")
    print("occupancy K=10 variants (blocks/SM): " + ", ".join(
        f"{k} {lib.variant_launch(v, None, None, None, None, None, 0, 0, None)}"
        for k, v in VARIANTS.items()))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def old(x, c, z):
        t, s = x.shape
        y, zo = torch.empty_like(x), torch.empty_like(z)
        ck(lib.old_cascade_launch(x.data_ptr(), c.data_ptr(), z.data_ptr(), y.data_ptr(),
                                  zo.data_ptr(), t, s, c.shape[0], stream()), "old")
        return y, zo

    def new(x, c, z, use=lib):
        t, s = x.shape
        sc = iops.cascade_schedule(t, s, c.shape[0])
        y, zo = torch.empty_like(x), torch.empty_like(z)
        ck(use.iir_cascade_launch(x.data_ptr(), c.data_ptr(), z.data_ptr(), y.data_ptr(),
                                  zo.data_ptr(), t, s, c.shape[0], sc.grid,
                                  sc.steady[1], sc.drain[1], sc.chunks, stream()),
           "shipped")
        return y, zo

    def variant(v):
        def run(x, c, z):
            t, s = x.shape
            y, zo = torch.empty_like(x), torch.empty_like(z)
            ck(lib.variant_launch(v, x.data_ptr(), c.data_ptr(), z.data_ptr(), y.data_ptr(),
                                  zo.data_ptr(), t, s, stream()), f"variant {v}")
            return y, zo
        return run

    def chained(fn, x, c, z, blocks=2):
        outs = []
        for _ in range(blocks):
            y, z = fn(x, c, z)
            outs.append((y, z))
        return outs

    def same(a, b):
        return all(torch.equal(p, q) for pa, pb in zip(a, b) for p, q in zip(pa, pb))

    ok = True
    n_shapes = 0
    worst_twin = 0.0
    for k in KS:
        for s in SS:
            line = []
            for tracks in TRACKS:
                x, c, z = inputs(tracks, s, k, dev)
                ro = chained(old, x, c, z)
                rn, rn2 = chained(new, x, c, z), chained(new, x, c, z)
                bit, det = same(ro, rn), same(rn, rn2)
                var = ""
                if k == 10:
                    vs = [same(ro, chained(variant(v), x, c, z)) for v in VARIANTS.values()]
                    var = " var " + "".join("=" if b else "x" for b in vs)
                    ok = ok and all(vs)
                tw = ""
                if tracks in TWIN_TRACKS:
                    zp, e = z, 0.0
                    for (yk, zk), (yo, _) in zip(rn, ro):
                        yp, zp = iops.iir_cascade_plain(x, c, zp)
                        e = max(e, (yk - yp).abs().max().item(), (zk - zp).abs().max().item(),
                                (yo - yp).abs().max().item())
                    worst_twin = max(worst_twin, e)
                    ok = ok and e <= ATOL
                    tw = f" twin {e:.2g}"
                ok = ok and bit and det
                n_shapes += 1
                line.append(f"T={tracks}: old {'=' if bit else 'DIFFERS'}, "
                            f"rerun {'=' if det else 'DIFFERS'}{var}{tw}")
            print(f"check K={k} S={s}: " + "; ".join(line))
    print(f"{n_shapes} shapes: shipped bit for bit the old kernel's and run to run, "
          f"variants too, every kernel within {ATOL:g} of the twin (worst "
          f"{worst_twin:.3g}): {ok}")

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
        return sorted(ts)[len(ts) // 2]

    for tracks in (FULL[0], 128):
        s, k = FULL[1], FULL[2]
        x, c, z = inputs(tracks, s, k, dev)
        y = torch.empty_like(x)
        order = ["old", "shipped"]
        if tracks == FULL[0]:
            order += [f"variant {v}" for v in VARIANTS] + ["copy of the bytes"]
        order += ["shipped", "old"]
        times = {}
        for name in order:
            if name == "old":
                f = lambda: old(x, c, z)  # noqa: E731
            elif name == "shipped":
                f = lambda: new(x, c, z)  # noqa: E731
            elif name == "copy of the bytes":
                f = lambda: y.copy_(x)  # noqa: E731
            else:
                f = (lambda run: lambda: run(x, c, z))(variant(VARIANTS[name[8:]]))
            times.setdefault(name, []).append(median_ms(f))
        print(f"times T={tracks} S={s} K={k} (ms, CUDA events, median of 20 x 10 "
              "calls): " + "; ".join(f"{n} " + " / ".join(f"{v:.4f}" for v in vs)
                                     for n, vs in times.items()))

    tracks, s, k = FULL
    x, c, z = inputs(tracks, s, k, dev)
    y, zo = torch.empty_like(x), torch.empty_like(z)
    nw = tracks // 32
    prof = torch.zeros(nw * 8, dtype=torch.int64, device=dev)
    for _ in range(2):
        ck(lib.old_cascade_profile(x.data_ptr(), c.data_ptr(), z.data_ptr(), y.data_ptr(),
                                   zo.data_ptr(), tracks, s, prof.data_ptr(), stream()),
           "old profile")
    torch.cuda.synchronize()
    pr = prof.view(-1, 8).cpu().numpy().astype(np.float64) / max_mhz
    print(f"phases old kernel ({nw} warps; mean us a warp): "
          + ", ".join(f"{n} {pr[:, q].mean():.2f}" for q, n in enumerate(OLD_PHASES))
          + f"; total {pr[:, 6].mean():.2f} (max {pr[:, 6].max():.2f})")

    prof.zero_()
    ptr = ctypes.c_void_p(prof.data_ptr())
    plib.cascade_prof_set.argtypes = [ctypes.c_void_p]
    ck(plib.cascade_prof_set(ptr), "cascade_prof_set")
    new(x, c, z, use=plib)
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    a.record()
    new(x, c, z, use=plib)
    e.record()
    torch.cuda.synchronize()
    pr = prof.view(-1, 8).cpu().numpy().astype(np.float64) / max_mhz
    print(f"phases shipped kernel, profiled build ({a.elapsed_time(e):.4f} ms; {nw} warps; "
          "mean us a warp): " + ", ".join(f"{n} {pr[:, q].mean():.2f}"
                                          for q, n in NEW_PHASES.items())
          + f"; total {pr[:, 0].mean():.2f} (max {pr[:, 0].max():.2f})")
    return ok


def chain_part(lib, plib, log, sass, out_dir, max_mhz) -> bool:
    """The per-sample chain cascade (the module docstring's second list)."""
    fn = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
        if not fn or not ("Used" in ln or "spill" in ln):
            continue
        info = ln.split(":", 1)[-1].strip()
        old = re.search(r"old_chain_kernelILi(\d+)E", fn)
        new = re.search(r"iir_cascade_chain_kernelILi(\d+)ELb([01])ELi(\d)ELb([01])E", fn)
        if old and old.group(1) in ("1", "10", "16"):
            print(f"ptxas chain old K={old.group(1)}: {info}")
        elif new and new.group(1) in ("1", "10", "16"):
            k, tma, ring, const = new.groups()
            label = {("1", "3", "1"): "shipped tma", ("0", "1", "1"): "shipped staged",
                     ("1", "3", "0"): "variant no constant bank",
                     ("1", "1", "1"): "variant no ring"}.get((tma, ring, const), fn)
            print(f"ptxas chain {label} K={k}: {info}")
    for label, pat in (("chain_old", r"old_chain_kernelILi10E"),
                       ("chain_tma", r"iir_cascade_chain_kernelILi10ELb1ELi3ELb1E"),
                       ("chain_staged", r"iir_cascade_chain_kernelILi10ELb0ELi1ELb1E")):
        name, loops = hot_loops(sass, pat, "FFMA")
        for blk in re.split(r"\n\s+Function : ", sass)[1:]:
            if blk.split("\n", 1)[0].strip() == name:
                (out_dir / f"sass_{label}.txt").write_text(blk)
        if loops:
            top = loops[0]
            stage_samples = (top["FFMA"] + top["FMUL"]) / 5
            print(f"sass {label} K=10: densest FFMA loop {sum(top.values())} instructions, "
                  f"{stage_samples:g} stage-samples, "
                  f"{sum(top.values()) / max(stage_samples, 1):.2f} a stage-sample, "
                  f"MOV {top['MOV']}: " + ", ".join(f"{k} {v}" for k, v in top.most_common(16)))

    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = 65536 // (32 * iops.CHAIN_WARPS)
    for k in (1, 10, 16):
        occ = {r: lib.chain_occupancy(k, r) for r in (-1, 0, 1)}
        print(f"occupancy chain K={k} (blocks/SM; waves at 65,536 tracks): old {occ[-1]} of 128 "
              f"threads ({512 / max(occ[-1] * sms, 1):.2f}); tma {occ[0]} of "
              f"{iops.CHAIN_WARPS} warps ({grid / max(occ[0] * sms, 1):.2f}); staged {occ[1]} "
              f"({grid / max(occ[1] * sms, 1):.2f})")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def old(x, c, z):
        t, s = x.shape
        y, zo = torch.empty_like(x), torch.empty_like(z)
        ck(lib.old_chain_launch(x.data_ptr(), c.data_ptr(), z.data_ptr(), y.data_ptr(),
                                zo.data_ptr(), t, s, c.shape[0], stream()), "old chain")
        return y, zo

    def new(x, c, z, route=None, use=lib):
        """The shipped kernel on chain_schedule's route, or on ``route``
        (the C entry takes the staged route at any shape)."""
        t, s = x.shape
        y, zo = torch.empty_like(x), torch.empty_like(z)
        sc = iops.chain_schedule(t, s, x.data_ptr())
        route = route or sc.route
        ck(use.iir_cascade_chain_launch(
            x.data_ptr(), c.data_ptr(), z.data_ptr(), y.data_ptr(), zo.data_ptr(), t, s,
            c.shape[0], iops.CHAIN_ROUTES.index(route), sc.grid, sc.chunks, stream()),
            f"chain {route}")
        return y, zo

    def variant(v):
        def run(x, c, z):
            t, s = x.shape
            y, zo = torch.empty_like(x), torch.empty_like(z)
            ck(lib.chain_variant_launch(v, x.data_ptr(), c.data_ptr(), z.data_ptr(),
                                        y.data_ptr(), zo.data_ptr(), t, s, stream()),
               f"chain variant {v}")
            return y, zo
        return run

    def chained(f, x, c, z, blocks=2):
        outs = []
        for _ in range(blocks):
            y, z = f(x, c, z)
            outs.append((y, z))
        return outs

    def same(a, b):
        return all(torch.equal(p, q) for pa, pb in zip(a, b) for p, q in zip(pa, pb))

    def unaligned(x):
        """x's values in a contiguous tensor 4 bytes past a 16-byte boundary."""
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        u = buf[1:].view(x.shape)
        u.copy_(x)
        return u

    ok = True
    n_shapes = 0
    worst_twin = 0.0
    routes_seen = {"tma": 0, "staged": 0}
    for k in KS:
        for s in SS:
            line = []
            for tracks in TRACKS:
                x, c, z = inputs(tracks, s, k, dev)
                ro = chained(old, x, c, z)
                rule = iops.chain_schedule(tracks, s, x.data_ptr()).route
                rn, rn2 = chained(new, x, c, z), chained(new, x, c, z)
                bit, det = same(ro, rn), same(rn, rn2)
                routes_seen[rule] += 1
                txt = f"T={tracks} {rule}: old {'=' if bit else 'DIFFERS'}, rerun {'=' if det else 'DIFFERS'}"
                if rule == "tma":
                    rs = chained(lambda a, b, d: new(a, b, d, "staged"), x, c, z)
                    st_bit = same(ro, rs)
                    ok = ok and st_bit
                    routes_seen["staged"] += 1
                    txt += f", staged {'=' if st_bit else 'DIFFERS'}"
                    if k == 10:
                        vs = [same(ro, chained(variant(v), x, c, z))
                              for v in CHAIN_VARIANTS.values()]
                        cp = variant(CHAIN_COPY)(x, c, z)[0]
                        vs.append(torch.equal(cp, x))
                        ok = ok and all(vs)
                        txt += " var " + "".join("=" if b else "x" for b in vs)
                    if tracks == 1000:
                        ru = chained(new, unaligned(x), c, z)
                        u_bit = same(ro, ru)
                        ok = ok and u_bit
                        txt += f", unaligned x (staged) {'=' if u_bit else 'DIFFERS'}"
                if tracks in TWIN_TRACKS:
                    zp, e = z, 0.0
                    for (yk, zk), (yo, _) in zip(rn, ro):
                        yp, zp = iops.iir_cascade_plain(x, c, zp)
                        e = max(e, (yk - yp).abs().max().item(), (zk - zp).abs().max().item(),
                                (yo - yp).abs().max().item())
                    worst_twin = max(worst_twin, e)
                    ok = ok and e <= ATOL
                    txt += f", twin {e:.2g}"
                ok = ok and bit and det
                n_shapes += 1
                line.append(txt)
            print(f"check chain K={k} S={s}: " + "; ".join(line))
    # Every depth the port builds, on both routes, at two shapes.
    depth_line = []
    for k in range(1, 17):
        for tracks, s in ((1000, 96), (33, 521)):
            x, c, z = inputs(tracks, s, k, dev)
            ro = chained(old, x, c, z)
            bit = same(ro, chained(new, x, c, z)) and same(
                ro, chained(lambda a, b, d: new(a, b, d, "staged"), x, c, z))
            ok = ok and bit
            if not bit:
                depth_line.append(f"K={k} {tracks}x{s} DIFFERS")
    print("check chain every K in 1..16 at 1000 x 96 (both routes) and 33 x 521 "
          "(staged): bit for bit the old kernel's"
          + (": " + ", ".join(depth_line) if depth_line else " at all"))
    print(f"{n_shapes} shapes ({routes_seen['tma']} on the TMA route, {routes_seen['staged']} "
          f"runs of the staged route): outputs and states bit for bit the old chain kernel's on "
          f"both routes, run to run, variants too, every kernel within {ATOL:g} of the twin "
          f"(worst {worst_twin:.3g}): {ok}")

    cycles = spin_cycles_per_ms()

    def median_ms(f, reps=20, calls=10):
        f()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)  # the host enqueues the calls meanwhile
            a.record()
            for _ in range(calls):
                f()
            e.record()
            e.synchronize()
            ts.append(a.elapsed_time(e) / calls)
        return sorted(ts)[len(ts) // 2]

    tracks, s, k = FULL
    x, c, z = inputs(tracks, s, k, dev)
    y = torch.empty_like(x)
    runs = {"old": lambda: old(x, c, z), "shipped": lambda: new(x, c, z),
            "staged route": lambda: new(x, c, z, "staged"),
            "copy of the bytes": lambda: y.copy_(x)}
    runs.update({f"variant {n}": (lambda r: lambda: r(x, c, z))(variant(v))
                 for n, v in CHAIN_VARIANTS.items()})
    runs["its copies alone"] = lambda: variant(CHAIN_COPY)(x, c, z)
    order = (["old", "shipped"] + [f"variant {n}" for n in CHAIN_VARIANTS]
             + ["staged route", "its copies alone", "copy of the bytes", "shipped",
                "old"])
    times = {}
    for name in order:
        times.setdefault(name, []).append(median_ms(runs[name]))
    peaks = json.loads((REPO / "gpuaudiobench_tpu_torch" / "utils" /
                        "measured_peaks.json").read_text())["peaks"]
    nbytes = 8 * tracks * s + 16 * k * tracks + 20 * k
    bound = nbytes / 3.35e12 * 1e3
    bound_m = nbytes / peaks["hbm_bytes_per_sec"] * 1e3
    best = min(times["shipped"])
    print(f"times chain T={tracks} S={s} K={k} (ms, CUDA events behind a spin, median of "
          "20 x 10 calls): " + "; ".join(f"{n} " + " / ".join(f"{v:.4f}" for v in vs)
                                         for n, vs in times.items())
          + f"; bound {bound:.4f} [{bound_m:.4f} measured peak] ms: shipped at "
          f"{bound / best:.1%} [{bound_m / best:.1%}]")

    prof = torch.zeros(grid * iops.CHAIN_WARPS * 8, dtype=torch.int64, device=dev)
    plib.chain_prof_set.argtypes = [ctypes.c_void_p]
    ck(plib.chain_prof_set(ctypes.c_void_p(prof.data_ptr())), "chain_prof_set")
    new(x, c, z, use=plib)
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    a.record()
    new(x, c, z, use=plib)
    e.record()
    torch.cuda.synchronize()
    pr = prof.view(-1, 8).cpu().numpy().astype(np.float64) / max_mhz
    print(f"phases chain shipped kernel, profiled build ({a.elapsed_time(e):.4f} ms; "
          f"{pr.shape[0]} warps; mean us a warp): "
          + ", ".join(f"{n} {pr[:, q].mean():.2f}" for q, n in CHAIN_PHASES.items())
          + f"; total {pr[:, 0].mean():.2f} (max {pr[:, 0].max():.2f})")
    return ok

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(REPO / "build" / "cascade_stages"))
    ap.add_argument("--part", choices=("all", "systolic", "chain"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
              "--format=csv,noheader"])[1].strip()
    print(f"card: {smi}")
    max_mhz = float(smi.split(",")[-1].split()[0])
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.time()
    plain_path, prof_path, log = build(out_dir)
    print(f"build: both libraries in {time.time() - t0:.1f} s")
    _, sass = sh([str(Path(nvcc_path()).with_name("cuobjdump")), "-sass", str(plain_path)])
    lib, plib = bind(plain_path), bind(prof_path)
    ok = True
    if args.part in ("all", "systolic"):
        ok = systolic_part(lib, plib, log, sass, out_dir, max_mhz) and ok
    if args.part in ("all", "chain"):
        ok = chain_part(lib, plib, log, sass, out_dir, max_mhz) and ok
    print(f"card: {sh(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'])[1].strip()}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
