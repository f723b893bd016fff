#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure exits
nonzero:

1. Toolchain: torch, CUDA, nvcc, triton (optional) and the card's
   nvidia-smi name and power limit.
2. Build: the CUDA kernels from ``gpuaudiobench_tpu_torch/csrc``, one
   nvcc per source, all started together.
3. The two modal kernels (rotation and Gordon-Smith resonator) vs their
   plain twins on the card, under every contract of the modal bank, with
   the states chained over 2 blocks, at seven shapes up to the main
   path's (1,048,576 modes, 512 samples, 32 tracks), three of them with
   T_out not dividing 32 (12 and 3; 12,288 x 512 x 12 is the CLI path's
   own); CUDA-event times of each kernel and its twin at the main shape.
4. The four IIR kernels vs their plain twins, states chained over 3
   blocks, at 8 x 64, 640 x 128 and 65,536 x 512 (tracks x samples), the
   blockstate kernel at m = 16 and m = 128, and the systolic cascade vs
   the chain cascade at 1e-6; CUDA-event times of each kernel and twin at
   65,536 x 512, and of ``torch.matmul`` on the blockstate chunk products
   as a yardstick.
5. The Conv1D FIR kernel vs its plain twin in both edge modes at five
   (tracks, samples, taps) shapes up to the main path's 19,456 x 512 x
   1,024, among them each CLI path's own and one with L - 1 > S in
   bleed, on N(0, 0.1^2) IRs within 1e-5 absolute; at the main shape
   also on the benchmark's own IR bank within 1e-5 of the twin's peak;
   CUDA-event times of the kernel, the twin and
   ``torch.nn.functional.conv1d`` (cuDNN, TF32 off) at the main shape.
6. Main paths, each with every launch count reset just before and read
   just after, and the plain twins counted (none may run):
   ``gpuaudiobench_tpu_torch.bench.main()`` at its defaults; 512 chained
   resonator blocks at the main modal shape, the first checked against
   ``modal_reference_gs`` on spot tracks; then the CLI on IIRFilter (scan
   and blockstate) and BiquadChain at 65,536 tracks, IIRFilter at the
   CLI's default 128 tracks, ModalFilterBank at 12 tracks (T_out 12),
   Conv1D at 19,456 tracks (clamp) and 128 (bleed), Conv1D_accel at
   19,456, and FFT1D, gain, GainStats and NoOp at 65,536; each validates
   against the NumPy golden.
7. A ``{"kernels": [...]}`` line, the nvidia-smi line, and last the
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
# (12288, 512, 12) is ModalFilterBank's CLI path at 12 tracks.
SHAPES = [(4096, 32, 32), (960, 64, 32), (256, 32, 8), (3000, 64, 12),
          (999, 32, 3), (12288, 512, 12), MAIN_SHAPE]
OUT_RTOL = 1e-5  # max|kernel - plain| <= OUT_RTOL * max|plain|
STATE_ATOL = 1e-4
TIMING_REPS = 20
KERNEL_SOURCE = "gpuaudiobench_tpu_torch/csrc/modal_bank.cu"
REPLACES = "gpuaudiobench_tpu/ops/modal_pallas.py:55"
RES_REPLACES = "gpuaudiobench_tpu/ops/modal_pallas.py:104"
# The resonator path: blocks chained at MAIN_SHAPE, and the tracks whose
# first block is held against modal_reference_gs at 1e-5 of its peak
# (the reference's bar, tests/test_pallas_ops.py:432).
RES_BLOCKS = 512
RES_SPOT_TRACKS = (0, 13, 31)
RES_GS_RTOL = 1e-5

# The Conv1D FIR kernel (csrc/conv1d.cu), (tracks, samples, taps): kernel
# vs twin within 1e-5 absolute in both edge modes, on N(0, 0.1^2) IRs
# whose outputs are of unit scale (FMA contraction, ~1e-7 there);
# (6, 16, 40) has L - 1 > S, and (128, 512, 1024) is the CLI's bleed path.
# The benchmark's own IR bank (windowed sinc over L) gives outputs near
# 1e-3 rms, where 1e-5 absolute would pass a TF32 kernel; at CONV_FULL it
# is held within 1e-5 of the twin's peak instead.
CONV_FULL = (19456, 512, 1024)
CONV_SHAPES = [(130, 48, 16), (8, 64, 7), (6, 16, 40), (128, 512, 1024),
               CONV_FULL]
CONV_ATOL = 1e-5
CONV_BANK_RTOL = 1e-5
CONV_SOURCE = "gpuaudiobench_tpu_torch/csrc/conv1d.cu"
CONV_REPLACES = "gpuaudiobench_tpu/ops/conv_pallas.py:40"

# The IIR kernels (csrc/iir.cu), (tracks, samples) shapes. Kernel vs twin:
# 1e-5 absolute, outputs and states (FMA contraction and the blockstate
# product's summation order, ~1e-7 on unit-scale signals; the reference's
# bar for blockstate vs scan). Systolic vs chain: 1e-6 absolute and
# relative, the reference's cross-check.
IIR_FULL = (65536, 512)
IIR_SHAPES = [(8, 64), (640, 128), IIR_FULL]
IIR_ATOL = 1e-5
CASCADE_TOL = 1e-6
IIR_STAGES = 10
IIR_SOURCE = "gpuaudiobench_tpu_torch/csrc/iir.cu"
IIR_REPLACES = {
    "iir_biquad": "gpuaudiobench_tpu/ops/iir.py:49",
    "iir_biquad_blockstate": "gpuaudiobench_tpu/ops/iir.py:407",
    "iir_cascade": "gpuaudiobench_tpu/ops/iir.py:161",
    "iir_cascade_chain": "gpuaudiobench_tpu/ops/iir.py:130",
}
# The published H100 SXM peaks the bounds divide by (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# The CLI runs of the IIR slice: (label, argv, kernels that must launch).
CLI_COMMON = ["--nRuns", "30", "--warmup", "5", "--pipelineDepth", "512",
              "--verification", "spot", "--json"]
CLI_RUNS = [
    ("IIRFilter scan, 65536 tracks",
     ["--benchmark", "IIRFilter", "--nTracks", "65536"] + CLI_COMMON,
     ["iir_biquad"]),
    ("IIRFilter blockstate, 65536 tracks",
     ["--benchmark", "IIRFilter", "--nTracks", "65536", "--iirForm",
      "blockstate"] + CLI_COMMON,
     ["iir_biquad_blockstate"]),
    ("BiquadChain, 65536 tracks",
     ["--benchmark", "BiquadChain", "--nTracks", "65536"] + CLI_COMMON,
     ["iir_cascade", "iir_cascade_chain"]),
    ("IIRFilter scan, 128 tracks",
     ["--benchmark", "IIRFilter"] + CLI_COMMON,
     ["iir_biquad"]),
    ("ModalFilterBank, 12 tracks (T_out 12)",
     ["--benchmark", "ModalFilterBank", "--nTracks", "12"] + CLI_COMMON,
     ["modal_bank"]),
    ("Conv1D clamp, 19456 tracks",
     ["--benchmark", "Conv1D", "--nTracks", "19456"] + CLI_COMMON,
     ["conv1d"]),
    ("Conv1D bleed, 128 tracks",
     ["--benchmark", "Conv1D", "--convEdgeMode", "bleed"] + CLI_COMMON,
     ["conv1d"]),
    ("Conv1D_accel, 19456 tracks",
     ["--benchmark", "Conv1D_accel", "--nTracks", "19456"] + CLI_COMMON,
     []),
] + [(f"{name}, 65536 tracks",
      ["--benchmark", name, "--nTracks", "65536"] + CLI_COMMON, [])
     for name in ("FFT1D", "gain", "GainStats", "NoOp")]


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


def compare(torch, ops, shape, device):
    """Every contract of both kernels, 2 chained blocks; returns max
    |kernel - plain| of the outputs, (rotation, resonator)."""
    m, s, t = shape
    x = make_inputs(torch, m, seed=m + s + t, device=device)
    before = dict(ops.KERNEL_LAUNCHES)
    worst = {"rotation": 0.0, "res": 0.0}

    def check_out(name, got, want, form="rotation"):
        if tuple(got.shape) != tuple(want.shape):
            fail(f"{shape} {name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
        if not torch.isfinite(got).all():
            fail(f"{shape} {name}: non-finite output")
        err = (got - want).abs().max().item()
        peak = want.abs().max().item()
        if err > OUT_RTOL * peak:
            fail(f"{shape} {name}: max|d| {err:.3g} > {OUT_RTOL:g} * {peak:.4g}")
        worst[form] = max(worst[form], err)
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

    # The resonator: its streaming step chained, then the round trip.
    eps, yk, qk = ops.res_init(x["cos_w"], x["sin_w"], x["amp"] * x["re"],
                               x["amp"] * x["im"])
    yp, qp = yk, qk
    for blk in range(2):
        out_k, yk, qk = ops.modal_res_step(eps, yk, qk, s, t)
        out_p, yp, qp = ops.modal_res_step_plain(eps, yp, qp, s, t)
        rel.append(check_out(f"res block {blk}", out_k, out_p, "res"))
    rerr = max((yk - yp).abs().max().item(), (qk - qp).abs().max().item())
    if not rerr <= STATE_ATOL:
        fail(f"{shape} resonator states: max|d| {rerr:.3g} > {STATE_ATOL:g}")
    out_k, sre2, _ = ops.modal_bank(x["amp"], x["cos_w"], x["sin_w"], sre,
                                    sim, s, t, algorithm="res")
    out_p, _, _ = ops.modal_bank_plain(x["amp"], x["cos_w"], x["sin_w"],
                                       sre, sim, s, t, algorithm="res")
    if sre2 is not sre:
        fail(f"{shape} modal_bank res did not return its input states")
    rel.append(check_out("res bank", out_k, out_p, "res"))
    torch.cuda.synchronize()
    launched = tuple(ops.KERNEL_LAUNCHES[k] - before[k]
                     for k in ("modal_bank", "modal_res"))
    if launched != (4, 3):
        fail(f"{shape}: {launched} (rotation, resonator) kernel launches, "
             "expected (4, 3)")
    print(f"compare M={m} S={s} T_out={t}: ok  max rel-to-peak "
          f"{max(rel):.3g}  state max|d| {max(serr, rerr):.3g}")
    return worst["rotation"], worst["res"]


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
    before = dict(ops.KERNEL_LAUNCHES)

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
    res_args = (*ops.res_init(x["cos_w"], x["sin_w"], re_f, im_f), s, t)
    res_p1 = median_ms(torch, lambda: ops.modal_res_step_plain(*res_args),
                       TIMING_REPS // 2, 1)
    res_k1 = median_ms(torch, lambda: ops.modal_res_step(*res_args),
                       TIMING_REPS, 10)
    res_k2 = median_ms(torch, lambda: ops.modal_res_step(*res_args),
                       TIMING_REPS, 10)
    res_p2 = median_ms(torch, lambda: ops.modal_res_step_plain(*res_args),
                       TIMING_REPS // 2, 1)
    for k in ("modal_bank", "modal_res"):
        if ops.KERNEL_LAUNCHES[k] == before[k]:
            fail(f"timing launched no {k} kernel")
    kern, plain = min(kern1, kern2), min(plain1, plain2)
    print(f"time M={m} S={s} T_out={t} (CUDA events, median of reps): "
          f"folded-step kernel {kern1:.4f} / {kern2:.4f} ms, plain twin "
          f"{plain1:.3f} / {plain2:.3f} ms; modal_bank kernel {bank:.4f} ms; "
          f"resonator step kernel {res_k1:.4f} / {res_k2:.4f} ms, plain "
          f"twin {res_p1:.3f} / {res_p2:.3f} ms")
    return {"modal_bank": (kern, plain),
            "modal_res": (min(res_k1, res_k2), min(res_p1, res_p2))}


def bound(bytes_moved: float, flops: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the FP32 operations over the FP32 peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def modal_bound():
    """modal_folded_step at the main shape: cos, sin, re, im read, re', im'
    written, (S, T_out) out; 7 FLOP per mode-sample (the rotation's 4
    multiplies and 2 adds, and the fold's add)."""
    m, s, t = MAIN_SHAPE
    return bound(4 * (6 * m + s * t), 7 * m * s)


def res_bound():
    """modal_res_step at the main shape: eps, y, q read, y', q' written,
    (S, T_out) out; 5 FLOP per mode-sample (2 multiplies, a subtraction
    and an add for the shears, and the fold's add)."""
    m, s, t = MAIN_SHAPE
    return bound(4 * (5 * m + s * t), 5 * m * s)


def conv_bound():
    """conv1d_direct at CONV_FULL: x and the IRs read, out written;
    2 FLOP (a multiply and an add) per output and tap."""
    tracks, s, l = CONV_FULL
    return bound(4 * (2 * tracks * s + tracks * l), 2 * tracks * s * l)


def iir_bounds(block_m: int):
    """Bounds at IIR_FULL. Every kernel reads x and writes y once, reads
    and writes its states and reads its coefficients. The biquad does 9
    FLOP per sample (w: 2 multiplies, 2 subtractions; y: 3 multiplies,
    2 adds), a cascade 9 per stage and sample. The blockstate product is
    lower-triangular: (m + 1) FLOP per sample on average, plus 4 for the
    state term and 5 for y; its tables are read too."""
    tracks, s = IIR_FULL
    n = tracks * s
    io = 4 * (2 * n)
    k = IIR_STAGES
    m = block_m
    return {
        "iir_biquad": bound(io + 4 * (4 * tracks + 5), 9 * n),
        "iir_biquad_blockstate": bound(
            io + 4 * (4 * tracks + 5 + m * m + 2 * m), (m + 10) * n),
        "iir_cascade": bound(io + 4 * (4 * k * tracks + 5 * k), 9 * k * n),
        "iir_cascade_chain": bound(io + 4 * (4 * k * tracks + 5 * k),
                                   9 * k * n),
    }


def iir_inputs(torch, tracks, s, device, stages=None, seed=11):
    """Seeded x (tracks, s) in [-1, 1), the fs/4 lowpass (or ``stages``
    staggered lowpasses) and a small nonzero state."""
    import numpy as np

    from gpuaudiobench_tpu_torch.utils.data import biquad_lowpass_coefficients

    g = np.random.Generator(np.random.MT19937(seed))
    x = (g.random((tracks, s), dtype=np.float32) * 2 - 1).astype(np.float32)
    if stages is None:
        c = np.array(biquad_lowpass_coefficients(0.25), np.float32)
        z = (g.random((tracks, 2), dtype=np.float32) - 0.5).astype(np.float32)
    else:
        c = np.array([biquad_lowpass_coefficients(0.25 - 0.0125 * i)
                      for i in range(stages)], np.float32)
        z = ((g.random((stages, tracks, 2), dtype=np.float32) - 0.5)
             * 0.2).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, c, z)]


def blockstate_tables(torch, iops, c, s, block_m, device):
    m = iops.blockstate_effective_m(s, block_m)
    taps, u = iops.blockstate_tables(c.cpu().numpy(), m)
    return torch.from_numpy(taps).to(device), torch.from_numpy(u).to(device)


def iir_fns(torch, iops, tracks, s, device, block_m=128):
    """{kernel name: (kernel, twin)} at one shape, each a function of
    (x, state) -> (y, state'), and the inputs (x, z1, zk) with z1 a
    single-stage and zk a cascade state."""
    x, c1, z1 = iir_inputs(torch, tracks, s, device)
    _, ck, zk = iir_inputs(torch, tracks, s, device, stages=IIR_STAGES)
    taps, u = blockstate_tables(torch, iops, c1, s, block_m, device)
    fns = {
        "iir_biquad": (lambda xx, z: iops.iir_biquad(xx, c1, z),
                       lambda xx, z: iops.iir_biquad_plain(xx, c1, z)),
        "iir_biquad_blockstate": (
            lambda xx, z: iops.iir_biquad_blockstate(xx, c1, taps, u, z),
            lambda xx, z: iops.iir_biquad_blockstate_plain(
                xx, c1, taps, u, z)),
        "iir_cascade": (lambda xx, z: iops.iir_cascade(xx, ck, z),
                        lambda xx, z: iops.iir_cascade_plain(xx, ck, z)),
        "iir_cascade_chain": (
            lambda xx, z: iops.iir_cascade_chain(xx, ck, z),
            lambda xx, z: iops.iir_cascade_plain(xx, ck, z)),
    }
    return fns, x, z1, zk


def compare_iir(torch, iops, tracks, s, device):
    """Each IIR kernel against its twin over 3 chained blocks (blockstate
    at m = 16 and m = 128), then systolic vs chain; returns max |kernel -
    twin| per kernel, outputs and states."""
    worst = {}
    sys_vs_chain = 0.0
    for block_m in (16, 128):
        fns, x, z1, zk = iir_fns(torch, iops, tracks, s, device, block_m)
        kinds = (["iir_biquad_blockstate"] if block_m == 16 else list(fns))
        outs = {}
        for kind in kinds:
            kern, plain = fns[kind]
            z0 = zk if kind.startswith("iir_cascade") else z1
            z0_copy = z0.clone()
            before = iops.KERNEL_LAUNCHES[kind]
            zkern, zplain = z0, z0
            err = 0.0
            for blk in range(3):
                yk, zkern = kern(x, zkern)
                yp, zplain = plain(x, zplain)
                if not (torch.isfinite(yk).all() and torch.isfinite(zkern).all()):
                    fail(f"{kind} {tracks}x{s}: non-finite output")
                e = max((yk - yp).abs().max().item(),
                        (zkern - zplain).abs().max().item())
                if not e <= IIR_ATOL:
                    fail(f"{kind} {tracks}x{s} m={block_m} block {blk}: "
                         f"max|kernel - twin| {e:.3g} > {IIR_ATOL:g}")
                err = max(err, e)
                outs.setdefault(kind, []).append((yk, zkern))
            torch.cuda.synchronize()
            if iops.KERNEL_LAUNCHES[kind] - before != 3:
                fail(f"{kind}: {iops.KERNEL_LAUNCHES[kind] - before} "
                     "launches for 3 blocks")
            if not torch.equal(z0, z0_copy):
                fail(f"{kind}: the input state was written")
            worst[kind] = max(worst.get(kind, 0.0), err)
        if block_m == 128:
            for (ys, zs), (yc, zc) in zip(outs["iir_cascade"],
                                          outs["iir_cascade_chain"]):
                for a, b in ((ys, yc), (zs, zc)):
                    d = (a - b).abs()
                    if not (d <= CASCADE_TOL + CASCADE_TOL * b.abs()).all():
                        fail(f"systolic vs chain {tracks}x{s}: max|d| "
                             f"{d.max().item():.3g} > {CASCADE_TOL:g} "
                             "abs + rel")
                    sys_vs_chain = max(sys_vs_chain, d.max().item())
    print(f"compare IIR {tracks}x{s}: ok  " + "  ".join(
        f"{k} {v:.3g}" for k, v in worst.items())
        + f"  systolic-vs-chain {sys_vs_chain:.3g}")
    return worst


def time_iir(torch, iops, device):
    """CUDA-event times (ms) at IIR_FULL of each kernel and its twin, in
    turns (twin, kernel, kernel, twin), and of torch.matmul on the
    blockstate chunk products: {name: (ms, plain_ms, library_ms)}."""
    tracks, s = IIR_FULL
    fns, x, z1, zk = iir_fns(torch, iops, tracks, s, device)
    out = {}
    plain_cascade = None
    for kind, (kern, plain) in fns.items():
        z = zk if kind.startswith("iir_cascade") else z1
        reps = 3 if kind.startswith("iir_cascade") else 5
        if kind == "iir_cascade_chain" and plain_cascade is not None:
            p1 = p2 = plain_cascade  # the same twin as iir_cascade's
        else:
            p1 = median_ms(torch, lambda: plain(x, z), reps, 1)
        k1 = median_ms(torch, lambda: kern(x, z), TIMING_REPS, 10)
        k2 = median_ms(torch, lambda: kern(x, z), TIMING_REPS, 10)
        if not (kind == "iir_cascade_chain" and plain_cascade is not None):
            p2 = median_ms(torch, lambda: plain(x, z), reps, 1)
        if kind == "iir_cascade":
            plain_cascade = min(p1, p2)
        library = None
        if kind == "iir_biquad_blockstate":
            m = 128
            _, c1, _ = iir_inputs(torch, tracks, s, device)
            taps, _ = blockstate_tables(torch, iops, c1, s, m, device)
            chunks = x.reshape(tracks * s // m, m)
            taps_t = taps.t().contiguous()
            library = median_ms(torch, lambda: torch.matmul(chunks, taps_t),
                                TIMING_REPS, 10)
        print(f"time {kind} {tracks}x{s} (CUDA events, median of reps): "
              f"kernel {k1:.4f} / {k2:.4f} ms, plain twin {p1:.3f} / "
              f"{p2:.3f} ms" + ("" if library is None else
                                f", torch.matmul chunk products "
                                f"{library:.4f} ms"))
        out[kind] = (min(k1, k2), min(p1, p2), library)
    return out


def res_path(torch, ops, models_modal, device):
    """The resonator's main path: RES_BLOCKS chained modal_res_step blocks
    at MAIN_SHAPE from res_init of the seeded bank. The first block is
    held against modal_reference_gs on RES_SPOT_TRACKS at RES_GS_RTOL of
    the golden's peak; every block must be finite. Returns the first
    block's max |kernel - golden| relative to the peak."""
    import numpy as np

    m, s, t = MAIN_SHAPE
    x = make_inputs(torch, m, seed=1, device=device)
    eps, y, q = ops.res_init(x["cos_w"], x["sin_w"], x["amp"] * x["re"],
                             x["amp"] * x["im"])
    outs = []
    for _ in range(RES_BLOCKS):
        out, y, q = ops.modal_res_step(eps, y, q, s, t)
        outs.append(out[:, list(RES_SPOT_TRACKS)])
    first = outs[0].cpu().numpy()
    if not (torch.isfinite(torch.stack(outs)).all()
            and torch.isfinite(y).all() and torch.isfinite(q).all()):
        fail("resonator path: non-finite output or state")
    # The golden on the spot tracks' modes only: mode j of the subset
    # folds onto j mod len(RES_SPOT_TRACKS), the position of its track.
    idx = np.stack([np.arange(k, m, t) for k in RES_SPOT_TRACKS],
                   axis=1).ravel()
    tabs = {k: v.cpu().numpy()[idx] for k, v in x.items()}
    gold = models_modal.modal_reference_gs(
        tabs["amp"], tabs["cos_w"], tabs["sin_w"], tabs["re"], tabs["im"],
        s, len(RES_SPOT_TRACKS)).T
    peak = float(np.abs(gold).max())
    rel = float(np.abs(first.astype(np.float64) - gold).max()) / peak
    if not rel <= RES_GS_RTOL:
        fail(f"resonator path: first block {rel:.3g} of the peak from "
             f"modal_reference_gs > {RES_GS_RTOL:g}")
    return rel


def conv_inputs(torch, tracks, s, l, device, bank=False, seed=5):
    """Seeded x (tracks, s) in [-1, 1) and N(0, 0.1^2) IRs, as the
    reference's kernel test draws them (tests/test_pallas_ops.py:248), or
    with ``bank`` the benchmark's windowed-sinc IR bank."""
    import numpy as np

    from gpuaudiobench_tpu_torch.utils.data import conv1d_impulse_responses

    g = np.random.Generator(np.random.MT19937(seed))
    x = (g.random((tracks, s), dtype=np.float32) * 2 - 1).astype(np.float32)
    if bank:
        ir = conv1d_impulse_responses(tracks, l)
    else:
        ir = (g.standard_normal((tracks, l), dtype=np.float32)
              * 0.1).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(ir).to(device)


def compare_conv(torch, cops, shape, device) -> float:
    """The FIR kernel vs its twin in both edge modes on N(0, 0.1^2) IRs,
    within CONV_ATOL; at CONV_FULL also on the benchmark's IR bank, within
    CONV_BANK_RTOL of the twin's peak. Returns max |kernel - twin| on the
    N(0, 0.1^2) IRs."""
    tracks, s, l = shape
    banks = (False, True) if shape == CONV_FULL else (False,)
    before = cops.KERNEL_LAUNCHES["conv1d"]
    worst = 0.0
    bank_rel = None
    for bank in banks:
        x, ir = conv_inputs(torch, tracks, s, l, device, bank=bank)
        for mode in ("clamp", "bleed"):
            got = cops.conv1d_direct(x, ir, mode)
            want = cops.conv1d_direct_plain(x, ir, mode)
            if (tuple(got.shape) != (tracks, s)
                    or not torch.isfinite(got).all()):
                fail(f"conv1d {shape} {mode}: shape {tuple(got.shape)} or "
                     "non-finite output")
            err = (got - want).abs().max().item()
            if bank:
                peak = want.abs().max().item()
                if not err <= CONV_BANK_RTOL * peak:
                    fail(f"conv1d {shape} {mode}, IR bank: max|kernel - "
                         f"twin| {err:.3g} > {CONV_BANK_RTOL:g} * {peak:.4g}")
                bank_rel = max(bank_rel or 0.0, err / peak)
                continue
            if not err <= CONV_ATOL:
                fail(f"conv1d {shape} {mode}: max|kernel - twin| {err:.3g} > "
                     f"{CONV_ATOL:g}")
            worst = max(worst, err)
    torch.cuda.synchronize()
    launched = cops.KERNEL_LAUNCHES["conv1d"] - before
    if launched != 2 * len(banks):
        fail(f"conv1d {shape}: {launched} launches, expected "
             f"{2 * len(banks)}")
    print(f"compare conv1d T={tracks} S={s} L={l}: ok  max|d| {worst:.3g} "
          "(clamp and bleed)" + ("" if bank_rel is None else
                                 f"; IR bank max|d| {bank_rel:.3g} of the "
                                 "twin's peak"))
    return worst


def time_conv(torch, cops, device):
    """CUDA-event times (ms) at CONV_FULL, clamp: the kernel, the twin and
    one ``torch.nn.functional.conv1d`` call on the padded window with
    groups = tracks (cuDNN, TF32 off as the port's FP32 needs; the
    flipped IRs make its correlation a convolution). Returns
    (ms, plain_ms, library_ms)."""
    import torch.nn.functional as F

    tracks, s, l = CONV_FULL
    x, ir = conv_inputs(torch, tracks, s, l, device, bank=True)
    xp = cops.padded_window(x, l, "clamp").unsqueeze(0).contiguous()
    w = ir.flip(1).unsqueeze(1).contiguous()
    p1 = median_ms(torch, lambda: cops.conv1d_direct_plain(x, ir), 3, 1)
    k1 = median_ms(torch, lambda: cops.conv1d_direct(x, ir), TIMING_REPS, 10)
    k2 = median_ms(torch, lambda: cops.conv1d_direct(x, ir), TIMING_REPS, 10)
    p2 = median_ms(torch, lambda: cops.conv1d_direct_plain(x, ir), 3, 1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib_out = F.conv1d(xp, w, groups=tracks)[0]
        lib_err = (lib_out - cops.conv1d_direct(x, ir)).abs().max().item()
        lib = median_ms(torch, lambda: F.conv1d(xp, w, groups=tracks), 5, 2)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"time conv1d {tracks}x{s}x{l} clamp (CUDA events, median of "
          f"reps): kernel {k1:.4f} / {k2:.4f} ms, plain twin {p1:.2f} / "
          f"{p2:.2f} ms, F.conv1d (cuDNN, TF32 off) {lib:.4f} ms "
          f"(max|F.conv1d - kernel| {lib_err:.3g})")
    return min(k1, k2), min(p1, p2), lib


class TwinCalls:
    """Counts calls of every plain twin while the main paths run (none may
    run on the card): wraps the module functions, which the wrappers look
    up by name."""

    NAMES = {"modal": ("modal_bank_plain", "modal_folded_step_plain",
                       "modal_res_step_plain"),
             "iir": ("iir_biquad_plain", "iir_biquad_blockstate_plain",
                     "iir_cascade_plain"),
             "conv": ("conv1d_direct_plain",)}

    def __init__(self, modules):
        self.modules = modules
        self.calls = 0
        self.saved = []

    def __enter__(self):
        for key, mod in self.modules.items():
            for name in self.NAMES[key]:
                fn = getattr(mod, name)
                self.saved.append((mod, name, fn))
                setattr(mod, name, self._counting(fn))
        return self

    def _counting(self, fn):
        def wrapped(*args, **kw):
            self.calls += 1
            return fn(*args, **kw)
        return wrapped

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def launch_counts(*modules):
    """Every wrapper's launch count, by kernel name (each ops module keeps
    its counts in a ``KERNEL_LAUNCHES`` dict)."""
    return {k: n for mod in modules for k, n in mod.KERNEL_LAUNCHES.items()}


def reset_counts(*modules):
    for mod in modules:
        for k in mod.KERNEL_LAUNCHES:
            mod.KERNEL_LAUNCHES[k] = 0


def cli_path(torch, cli, counts, label, argv, kernels):
    """One CLI run in-process, stdout captured; fails unless it exits 0,
    validation passed, the device tier used CUDA events and each of
    ``kernels`` launched. ``counts`` reads the launch counts, which the
    caller reset. Returns the launch counts of the run."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    launches = counts()
    if rc != 0:
        for ln in lines[-20:]:
            print(f"cli: {ln}")
        fail(f"{label}: cli.main returned {rc}")
    try:
        start = lines.index("{")
        end = len(lines) - 1 - lines[::-1].index("}")
        rec = json.loads("\n".join(lines[start:end + 1]))
    except ValueError:
        fail(f"{label}: no JSON result in the CLI output")
    v = rec.get("validation", {})
    if v.get("status") != "SUCCESS":
        fail(f"{label}: validation {v}")
    dstats = rec.get("device_statistics", {})
    if dstats.get("method") != "cuda-events":
        fail(f"{label}: device timing method {dstats.get('method')!r}")
    for k in kernels:
        if launches[k] <= 0:
            fail(f"{label}: {k} was not launched")
    st, sat = rec["statistics"], rec.get("saturated", {})
    marg = sat.get("marginal", {})
    print(f"cli {label}: {wall:.1f} s, round trip p50 {st['p50_ms']:.4f} / "
          f"p99 {st['p99_ms']:.4f} ms, device p50 {dstats['median_ms']:.4f} "
          f"ms [cuda-events], saturated p50 {sat.get('p50_ms', 0):.4f} ms, "
          f"marginal p50 {marg.get('p50_ms', 0):.4f} ms "
          f"({sat.get('blocks_per_sec', 0):.1f} blocks/s "
          f"[{sat.get('blocks_per_sec_basis')}]), validation max error "
          f"{v['max_error']:.3g}, launches "
          + ", ".join(f"{k} {n}" for k, n in launches.items() if n))
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not importable")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    try:
        from gpuaudiobench_tpu_torch import bench, cli
        from gpuaudiobench_tpu_torch.models import modal as models_modal
        from gpuaudiobench_tpu_torch.ops import conv as cops
        from gpuaudiobench_tpu_torch.ops import iir as iops
        from gpuaudiobench_tpu_torch.ops import modal as ops
        from gpuaudiobench_tpu_torch.utils import build
        from gpuaudiobench_tpu_torch.utils import device as dev
    except ImportError as e:
        fail(f"the port's package is not importable here ({e}); run from "
             "the root of a checkout")

    t_start = time.perf_counter()
    smi = toolchain(torch, build, dev)
    device = dev.device("cuda")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the blockstate twin needs full FP32")

    t0 = time.perf_counter()
    libs = build.build_all(["modal_bank", "iir", "conv1d"])
    ops._lib()
    iops._lib()
    cops._lib()
    print(f"build: {', '.join(p.name for p in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")

    errs = [compare(torch, ops, shape, device) for shape in SHAPES]
    modal_err = {"modal_bank": max(e[0] for e in errs),
                 "modal_res": max(e[1] for e in errs)}
    modal_times = time_main_shape(torch, ops, device)

    t0 = time.perf_counter()
    iir_err = {}
    for tracks, s in IIR_SHAPES:
        for k, v in compare_iir(torch, iops, tracks, s, device).items():
            iir_err[k] = max(iir_err.get(k, 0.0), v)
    iir_times = time_iir(torch, iops, device)
    print(f"IIR kernels vs twins: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    conv_err = max(compare_conv(torch, cops, shape, device)
                   for shape in CONV_SHAPES)
    conv_times = time_conv(torch, cops, device)
    print(f"conv1d kernel vs twin: {time.perf_counter() - t0:.1f} s")

    # Main paths: every count is reset just before each path and read
    # just after; no plain twin may run in any of them.
    def counts():
        return launch_counts(ops, iops, cops)

    launches = {k: 0 for k in counts()}
    with TwinCalls({"modal": ops, "iir": iops, "conv": cops}) as twins:
        reset_counts(ops, iops, cops)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = bench.main()
        wall = time.perf_counter() - t0
        launches["modal_bank"] = ops.KERNEL_LAUNCHES["modal_bank"]
        lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
        for ln in lines:
            print(f"bench: {ln}")
        if rc != 0:
            fail(f"bench.main() returned {rc}")
        rec = json.loads(lines[-1])
        if rec.get("validation") != "passed":
            fail(f"bench validation: {rec.get('validation')}")
        if rec.get("kernel_launches", 0) <= 0 or launches["modal_bank"] <= 0:
            fail("the main path launched no kernel")
        print(f"main path: {wall:.1f} s, {launches['modal_bank']} kernel "
              "launches, validation passed")

        reset_counts(ops, iops, cops)
        t0 = time.perf_counter()
        res_rel = res_path(torch, ops, models_modal, device)
        launches["modal_res"] = ops.KERNEL_LAUNCHES["modal_res"]
        if launches["modal_res"] != RES_BLOCKS:
            fail(f"resonator path: {launches['modal_res']} launches for "
                 f"{RES_BLOCKS} blocks")
        print(f"resonator path: {RES_BLOCKS} chained blocks at M={MAIN_SHAPE[0]} "
              f"in {time.perf_counter() - t0:.1f} s, first block "
              f"{res_rel:.3g} of the peak from modal_reference_gs on tracks "
              f"{list(RES_SPOT_TRACKS)}")

        for label, argv, kernels in CLI_RUNS:
            reset_counts(ops, iops, cops)
            for k, n in cli_path(torch, cli, counts, label, argv,
                                 kernels).items():
                launches[k] += n
        if twins.calls:
            fail(f"a plain twin ran {twins.calls} times on the main paths")

    rows = []
    for name, replaces, (b_ms, b_by) in (
            ("modal_bank", REPLACES, modal_bound()),
            ("modal_res", RES_REPLACES, res_bound())):
        ms, p_ms = modal_times[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": modal_err[name],
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    iir_bound = iir_bounds(128)
    for name, replaces in IIR_REPLACES.items():
        ms, p_ms, lib_ms = iir_times[name]
        b_ms, b_by = iir_bound[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": IIR_SOURCE,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": iir_err[name],
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": lib_ms,
        })
    b_ms, b_by = conv_bound()
    rows.append({
        "name": "conv1d",
        "route": "cuda",
        "source": CONV_SOURCE,
        "replaces": CONV_REPLACES,
        "launches": launches["conv1d"],
        "max_abs_err": conv_err,
        "ms": conv_times[0],
        "plain_ms": conv_times[1],
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": conv_times[2],
    })
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
