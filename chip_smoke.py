#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure exits
nonzero:

1. Toolchain: torch, CUDA, nvcc, triton (optional) and the card's
   nvidia-smi name and power limit.
2. Build: the CUDA kernels from ``gpuaudiobench_tpu_torch/csrc``.
3. Kernel vs plain twin on the card, under both contracts of the modal
   bank, with the states chained over 2 blocks, at four shapes up to the
   main path's (1,048,576 modes, 512 samples, 32 tracks); CUDA-event
   times of the kernel and the twin at the main shape.
4. Main path: ``gpuaudiobench_tpu_torch.bench.main()`` at its defaults,
   which validates against the NumPy golden; the kernel's launch count
   is reset just before and read just after.
5. A ``{"kernels": [...]}`` line, the nvidia-smi line, and last the
   ``{"ok": true, "device": {...}}`` line.

Needs one CUDA device; exits 1 without printing a result when there is
none, or when the port's package is not beside this script.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time

MAIN_SHAPE = (1048576, 512, 32)
SHAPES = [(4096, 32, 32), (960, 64, 32), (256, 32, 8), MAIN_SHAPE]
OUT_RTOL = 1e-5  # max|kernel - plain| <= OUT_RTOL * max|plain|
STATE_ATOL = 1e-4
TIMING_REPS = 20
KERNEL_SOURCE = "gpuaudiobench_tpu_torch/csrc/modal_bank.cu"
REPLACES = "gpuaudiobench_tpu/ops/modal_pallas.py:55"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def toolchain(torch, build, dev) -> str:
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    nvcc = build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    print(f"nvcc {nvcc}: {ver.stdout.strip().splitlines()[-1]}")
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton not importable (not needed)")
    smi = dev.nvidia_smi_identity()
    if smi is None:
        fail("nvidia-smi gave no name and power limit")
    print(f"card: {smi}")
    return smi


def make_inputs(torch, m: int, seed: int, device):
    import numpy as np

    g = np.random.Generator(np.random.MT19937(seed))
    amp = g.random(m, dtype=np.float32)
    w = (np.float32(2 * np.pi) * g.random(m, dtype=np.float32)
         * np.float32(0.45)).astype(np.float32)
    tabs = {
        "amp": amp,
        "cos_w": np.cos(w).astype(np.float32),
        "sin_w": np.sin(w).astype(np.float32),
        "re": (g.random(m, dtype=np.float32) * 2 - 1).astype(np.float32),
        "im": (g.random(m, dtype=np.float32) * 2 - 1).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in tabs.items()}


def compare(torch, ops, shape, device) -> float:
    """Both contracts, 2 chained blocks; returns max |kernel - plain| of
    the outputs."""
    m, s, t = shape
    x = make_inputs(torch, m, seed=m + s + t, device=device)
    before = ops.KERNEL_LAUNCHES
    worst = 0.0

    def check_out(name, got, want):
        nonlocal worst
        if tuple(got.shape) != tuple(want.shape):
            fail(f"{shape} {name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
        if not torch.isfinite(got).all():
            fail(f"{shape} {name}: non-finite output")
        err = (got - want).abs().max().item()
        peak = want.abs().max().item()
        if err > OUT_RTOL * peak:
            fail(f"{shape} {name}: max|d| {err:.3g} > {OUT_RTOL:g} * {peak:.4g}")
        worst = max(worst, err)
        return err / peak

    # Streaming contract: rotated states carried from block to block.
    re_k, im_k = x["amp"] * x["re"], x["amp"] * x["im"]
    re_p, im_p = re_k, im_k
    rel = []
    for blk in range(2):
        out_k, re_k, im_k = ops.modal_folded_step(
            x["cos_w"], x["sin_w"], re_k, im_k, s, t)
        out_p, re_p, im_p = ops.modal_folded_step_plain(
            x["cos_w"], x["sin_w"], re_p, im_p, s, t)
        rel.append(check_out(f"folded block {blk}", out_k, out_p))
    serr = max((re_k - re_p).abs().max().item(),
               (im_k - im_p).abs().max().item())
    if not serr <= STATE_ATOL:
        fail(f"{shape} rotated states: max|d| {serr:.3g} > {STATE_ATOL:g}")

    # Round-trip contract: input states come back unchanged.
    sre, sim = x["re"], x["im"]
    for blk in range(2):
        out_k, sre2, sim2 = ops.modal_bank(
            x["amp"], x["cos_w"], x["sin_w"], sre, sim, s, t)
        if sre2 is not sre or sim2 is not sim:
            fail(f"{shape} modal_bank did not return its input states")
        out_p, _, _ = ops.modal_bank_plain(
            x["amp"], x["cos_w"], x["sin_w"], sre, sim, s, t)
        rel.append(check_out(f"bank block {blk}", out_k, out_p))
    torch.cuda.synchronize()
    if ops.KERNEL_LAUNCHES - before != 4:
        fail(f"{shape}: {ops.KERNEL_LAUNCHES - before} kernel launches, "
             "expected 4")
    print(f"compare M={m} S={s} T_out={t}: ok  max rel-to-peak "
          f"{max(rel):.3g}  state max|d| {serr:.3g}")
    return worst


def median_ms(torch, fn, reps: int, calls: int) -> float:
    """Median over ``reps`` of the CUDA-event time of ``calls``
    back-to-back calls, per call (so host launch gaps overlap the
    device's work, as they do on the main path)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    times.sort()
    return times[len(times) // 2]


def time_main_shape(torch, ops, device):
    m, s, t = MAIN_SHAPE
    x = make_inputs(torch, m, seed=1, device=device)
    re_f, im_f = x["amp"] * x["re"], x["amp"] * x["im"]
    args = (x["cos_w"], x["sin_w"], re_f, im_f, s, t)
    before = ops.KERNEL_LAUNCHES

    def plain():
        return ops.modal_folded_step_plain(*args)

    def kernel():
        return ops.modal_folded_step(*args)

    # In turns (plain, kernel, kernel, plain) so drift shows as a spread.
    plain1 = median_ms(torch, plain, TIMING_REPS // 2, 1)
    kern1 = median_ms(torch, kernel, TIMING_REPS, 10)
    kern2 = median_ms(torch, kernel, TIMING_REPS, 10)
    plain2 = median_ms(torch, plain, TIMING_REPS // 2, 1)
    bank = median_ms(torch, lambda: ops.modal_bank(
        x["amp"], x["cos_w"], x["sin_w"], x["re"], x["im"], s, t),
        TIMING_REPS, 10)
    if ops.KERNEL_LAUNCHES == before:
        fail("timing launched no kernel")
    kern, plain = min(kern1, kern2), min(plain1, plain2)
    print(f"time M={m} S={s} T_out={t} (CUDA events, median of reps): "
          f"folded-step kernel {kern1:.4f} / {kern2:.4f} ms, plain twin "
          f"{plain1:.3f} / {plain2:.3f} ms; modal_bank kernel {bank:.4f} ms")
    return kern, plain


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not importable")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    try:
        from gpuaudiobench_tpu_torch import bench
        from gpuaudiobench_tpu_torch.ops import modal as ops
        from gpuaudiobench_tpu_torch.utils import build
        from gpuaudiobench_tpu_torch.utils import device as dev
    except ImportError as e:
        fail(f"the port's package is not importable here ({e}); run from "
             "the root of a checkout")

    smi = toolchain(torch, build, dev)
    device = dev.device("cuda")

    t0 = time.perf_counter()
    lib_path = build.build("modal_bank")
    ops._lib()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")

    launches_before = ops.KERNEL_LAUNCHES
    max_err = max(compare(torch, ops, shape, device) for shape in SHAPES)
    if ops.KERNEL_LAUNCHES <= launches_before:
        fail("the comparison launched no kernel")
    kern_ms, plain_ms = time_main_shape(torch, ops, device)

    # Main path: count only the launches it makes.
    ops.KERNEL_LAUNCHES = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench.main()
    wall = time.perf_counter() - t0
    launches = ops.KERNEL_LAUNCHES
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    for ln in lines:
        print(f"bench: {ln}")
    if rc != 0:
        fail(f"bench.main() returned {rc}")
    rec = json.loads(lines[-1])
    if rec.get("validation") != "passed":
        fail(f"bench validation: {rec.get('validation')}")
    if rec.get("kernel_launches", 0) <= 0 or launches <= 0:
        fail("the main path launched no kernel")
    print(f"main path: {wall:.1f} s, {launches} kernel launches, "
          f"validation passed")

    print(json.dumps({"kernels": [{
        "name": "modal_bank",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
