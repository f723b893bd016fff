"""Measure the modal bank kernel's redesign on one CUDA device.

    python3 tools/modal_stages/run.py [--out DIR]

Builds ``stages.cu`` (beside this file; it includes
``gpuaudiobench_tpu_torch/csrc/modal_bank.cu``) twice with nvcc, plain
and with ``-DMODAL_PROFILE``, and prints, one line each:

* the card (``nvidia-smi`` name, power limit, max SM clock) and toolchain;
* ``ptxas -v`` registers, spills and shared memory of the old partials
  kernel, the shipped kernel (rotation and resonator, 21 modes a thread)
  and both reduce kernels;
* blocks an SM (occupancy API) of the old and the shipped kernel, and the
  waves the old kernel's 512 blocks take;
* from ``cuobjdump -sass``, the instruction mix of the old and the
  shipped rotation kernel's sample loop;
* at each shape of CASES, the old pair, the shipped kernel and its
  variants against ``modal_folded_step_plain`` over 2 chained blocks (max
  |d| over the twin's peak), both forms' shipped states against the old
  kernel's bit for bit, and whether two runs of the shipped kernel agree
  bit for bit;
* CUDA-event times at 1,048,576 x 512 x 32 in turns (old, shipped,
  variants, shipped, old), the resonator old and shipped, and each reduce
  kernel alone (100 launches in a row, from C);
* clock64() phase sums per warp (microseconds at the max SM clock) of the
  old partials kernel and of the shipped kernel (the profiled build).

Needs one CUDA device, nvcc and cuobjdump (``$CUDA_HOME`` or
``/usr/local/cuda``). ``--out`` (default ``build/modal_stages``, which git
ignores) receives ptxas.txt and the SASS of the two rotation kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
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
from gpuaudiobench_tpu_torch.ops import modal as mops  # noqa: E402
from gpuaudiobench_tpu_torch.utils.build import NVCC_FLAGS, nvcc_path  # noqa: E402

MAIN = (1048576, 512, 32)
CASES = [MAIN, (4194304, 64, 32), (12288, 512, 12), (70048, 64, 32),
         (3000, 64, 12), (999, 32, 3), (64, 7, 1), (192, 16, 64),
         (33024, 40, 16), (4096, 32, 8)]
OUT_RTOL = 1e-5
# (modes a thread, rotation warps, fold warps); the shipped kernel is
# (21, 12, 4).
VARIANTS = {"(16, 16, 2)": 0, "(16, 16, 4)": 1, "(32, 8, 2)": 2,
            "(21, 12, 2)": 3}
NEW_PHASES = ["table loads", "empty wait", "rotation + sums", "full wait",
              "fold + partial", "state stores"]
OLD_PHASES = ["table loads", "rotation + lane_sums", "barrier 1",
              "fold + partial", "barrier 2", "state stores"]


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
    for name, extra in (("plain", []), ("prof", ["-DMODAL_PROFILE"])):
        lib = tmp / f"stages_{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, *extra, "-Xptxas", "-v", "-o", str(lib), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    for name, (lib, proc) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            print(logs[name][-4000:])
            raise SystemExit(f"nvcc failed for the {name} build")
    (out / "ptxas.txt").write_text(logs["plain"])
    return jobs["plain"][0], jobs["prof"][0], logs["plain"]


def bind(path):
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    sig = {
        "old_modal_num_blocks": [i, i], "old_modal_launch": [p] * 9 + [i] * 4 + [p],
        "old_res_launch": [p] * 7 + [i] * 4 + [p],
        "old_modal_profile": [p] * 8 + [i] * 3 + [p, p],
        "old_reduce_launch": [p, p, i, i, i, i, p], "new_reduce_launch": [p, p, i, i, i, i, p],
        "old_modal_occupancy": [], "variant_launch": [i] + [p] * 8 + [i] * 3 + [ip, p],
        "modal_prof_set": [p], "modal_bank_capacity": [i], "modal_bank_warps": [],
        "modal_bank_max_modes_per_thread": [],
        "modal_bank_launch": [p] * 9 + [i] * 7 + [p], "modal_res_launch": [p] * 7 + [i] * 7 + [p],
    }
    for fn, args in sig.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = i
    return lib


def ck(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(REPO / "build" / "modal_stages"))
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
    fn = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
        wanted = fn and re.search(r"modal_bank_partials|modal_bank_reduce|"
                                  r"modal_bank_kernelILb[01]ELi21ELi12ELi4E", fn)
        if wanted and ("Used" in ln or "spill" in ln):
            print(f"ptxas {fn}: {ln.split(':', 1)[-1].strip()}")
    _, sass = sh([str(Path(nvcc_path()).with_name("cuobjdump")), "-sass", str(plain_path)])
    for label, pat in (("old", r"old_form.*modal_bank_partialsILb0ELb0E"),
                       ("shipped", r"modal_bank_kernelILb0ELi21ELi12ELi4E")):
        name, loops = hot_loops(sass, pat, "FFMA")
        for blk in re.split(r"\n\s+Function : ", sass)[1:]:
            if blk.split("\n", 1)[0].strip() == name:
                (out_dir / f"sass_{label}.txt").write_text(blk)
        if loops:
            top = loops[0]
            print(f"sass {label} ({name}): densest FFMA loop {sum(top.values())} "
                  "instructions: " + ", ".join(f"{k} {v}" for k, v in top.most_common(12)))

    lib, plib = bind(plain_path), bind(prof_path)
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    old_per_sm = lib.old_modal_occupancy()
    cap = lib.modal_bank_capacity(0)
    old_blocks = lib.old_modal_num_blocks(MAIN[0], MAIN[2])
    print(f"occupancy: old {old_per_sm} blocks/SM of 256 threads, {old_blocks} "
          f"blocks = {old_blocks / (old_per_sm * sms):.2f} waves on {sms} SMs; "
          f"shipped {cap // sms} block/SM of {lib.modal_bank_warps()} rotation warps "
          "and its fold warps "
          f"(capacity {cap}, resonator {lib.modal_bank_capacity(1)})")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def tables(m, seed):
        g = np.random.Generator(np.random.MT19937(seed))
        amp = g.random(m, dtype=np.float32)
        w = (np.float32(2 * np.pi) * g.random(m, dtype=np.float32)
             * np.float32(0.45)).astype(np.float32)
        ph_re = (g.random(m, dtype=np.float32) * 2 - 1) * amp
        ph_im = (g.random(m, dtype=np.float32) * 2 - 1) * amp
        return [torch.from_numpy(a.astype(np.float32)).to(dev)
                for a in (np.cos(w), np.sin(w), ph_re, ph_im)]

    def old(form, a, b, s0, s1, s, t):
        m = s0.shape[0]
        part = torch.empty((lib.old_modal_num_blocks(m, t), s, t), device=dev)
        o, s0o, s1o = torch.empty((s, t), device=dev), torch.empty_like(s0), torch.empty_like(s1)
        ptrs = [s0.data_ptr(), s1.data_ptr(), s0o.data_ptr(), s1o.data_ptr(),
                part.data_ptr(), o.data_ptr()]
        if form == "res":
            ck(lib.old_res_launch(a.data_ptr(), *ptrs, m, s, t, 0, stream()), "old res")
        else:
            ck(lib.old_modal_launch(a.data_ptr(), b.data_ptr(), None, *ptrs, m, s, t, 0,
                                    stream()), "old")
        return o, s0o, s1o

    def new(form, a, b, s0, s1, s, t, use=lib):
        m = s0.shape[0]
        sch = mops.modal_schedule(m, t, use.modal_bank_capacity(int(form == "res")),
                                  use.modal_bank_warps(),
                                  use.modal_bank_max_modes_per_thread())
        part = torch.empty((sch.n_partials, s, t), device=dev)
        o, s0o, s1o = torch.empty((s, t), device=dev), torch.empty_like(s0), torch.empty_like(s1)
        ptrs = [s0.data_ptr(), s1.data_ptr(), s0o.data_ptr(), s1o.data_ptr(),
                part.data_ptr(), o.data_ptr(), m, s, t, 0, sch.modes_per_thread,
                sch.grid, sch.passes, stream()]
        if form == "res":
            ck(use.modal_res_launch(a.data_ptr(), *ptrs), "shipped res")
        else:
            ck(use.modal_bank_launch(a.data_ptr(), b.data_ptr(), None, *ptrs), "shipped")
        return o, s0o, s1o

    gp = (ctypes.c_int * 2)()

    def variant(v, a, b, s0, s1, s, t):
        m = s0.shape[0]
        ck(lib.variant_launch(v, None, None, None, None, None, None, None, None,
                              m, s, t, gp, None), "variant schedule")
        part = torch.empty((gp[0] * gp[1], s, t), device=dev)
        o, s0o, s1o = torch.empty((s, t), device=dev), torch.empty_like(s0), torch.empty_like(s1)
        ck(lib.variant_launch(v, a.data_ptr(), b.data_ptr(), s0.data_ptr(), s1.data_ptr(),
                              s0o.data_ptr(), s1o.data_ptr(), part.data_ptr(), o.data_ptr(),
                              m, s, t, gp, stream()), f"variant {v}")
        return o, s0o, s1o

    ok = True
    for m, s, t in CASES:
        c, sn, ph_re, ph_im = tables(m, m + s + t)
        eps, y, q = mops.res_init(c, sn, ph_re, ph_im)
        sch = mops.modal_schedule(m, t, cap, lib.modal_bank_warps(),
                                  lib.modal_bank_max_modes_per_thread())
        line = (f"check M={m} S={s} T_out={t} (shipped: {sch.modes_per_thread} modes a "
                f"thread, grid {sch.grid}, {sch.passes} passes):")
        runs = {"old": lambda *a: old("rot", *a), "shipped": lambda *a: new("rot", *a)}
        runs.update({f"variant {k}": (lambda v: lambda *a: variant(v, *a))(v)
                     for k, v in VARIANTS.items()})
        states = {}
        for name, fn in runs.items():
            kre, kim, pre, pim, rel = ph_re, ph_im, ph_re, ph_im, 0.0
            for _ in range(2):
                ko, kre, kim = fn(c, sn, kre, kim, s, t)
                po, pre, pim = mops.modal_folded_step_plain(c, sn, pre, pim, s, t)
                rel = max(rel, (ko - po).abs().max().item() / po.abs().max().item())
            states[name] = (kre, kim)
            ok = ok and rel <= OUT_RTOL
            line += f"  {name} {rel:.3g}"
        same = all(torch.equal(x, y_) for x, y_ in zip(states["old"], states["shipped"]))
        a1, a2 = new("rot", c, sn, ph_re, ph_im, s, t), new("rot", c, sn, ph_re, ph_im, s, t)
        det = all(torch.equal(x, y_) for x, y_ in zip(a1, a2))
        ro, rn = old("res", eps, None, y, q, s, t), new("res", eps, None, y, q, s, t)
        rp = mops.modal_res_step_plain(eps, y, q, s, t)
        res_rel = (rn[0] - rp[0]).abs().max().item() / rp[0].abs().max().item()
        res_same = torch.equal(ro[1], rn[1]) and torch.equal(ro[2], rn[2])
        r2 = new("res", eps, None, y, q, s, t)
        res_det = all(torch.equal(x, y_) for x, y_ in zip(rn, r2))
        ok = ok and same and det and res_same and res_det and res_rel <= OUT_RTOL
        print(line + f"; states = old bit for bit: {same}; run to run: {det}; "
              f"resonator {res_rel:.3g}, states = old: {res_same}, run to run: {res_det}")
    print(f"every kernel within {OUT_RTOL:g} of the twin, shipped states bit for bit "
          f"the old kernel's, shipped deterministic: {ok}")

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

    m, s, t = MAIN
    c, sn, ph_re, ph_im = tables(m, 1)
    eps, y, q = mops.res_init(c, sn, ph_re, ph_im)
    times = {}
    order = ["old", "shipped"] + [f"variant {k}" for k in VARIANTS] + ["shipped", "old"]
    for name in order:
        if name == "old":
            f = lambda: old("rot", c, sn, ph_re, ph_im, s, t)  # noqa: E731
        elif name == "shipped":
            f = lambda: new("rot", c, sn, ph_re, ph_im, s, t)  # noqa: E731
        else:
            f = (lambda v: lambda: variant(v, c, sn, ph_re, ph_im, s, t))(VARIANTS[name[8:]])
        times.setdefault(name, []).append(median_ms(f))
    for name in ("old", "shipped", "shipped", "old"):
        times.setdefault(f"resonator {name}", []).append(median_ms(
            lambda: (old if name == "old" else new)("res", eps, None, y, q, s, t)))
    o = torch.empty((s, t), device=dev)
    for label, fn_, n in (("old reduce alone", lib.old_reduce_launch, old_blocks),
                          ("shipped reduce alone", lib.new_reduce_launch, cap)):
        part = torch.rand((n, s, t), device=dev)
        times[f"{label} ({n} partials)"] = [median_ms(
            lambda: ck(fn_(part.data_ptr(), o.data_ptr(), n, s, t, 100, stream()), label),
            calls=1) / 100]
    print(f"times M={m} S={s} T_out={t} (ms, CUDA events, median of 20 x 10 calls; "
          "states kept, as modal_folded_step):")
    for k, v in times.items():
        print(f"  {k}: " + " / ".join(f"{x:.4f}" for x in v))

    prof = torch.zeros(old_blocks * 8 * 8, dtype=torch.int64, device=dev)
    part = torch.empty((old_blocks, s, t), device=dev)
    s0o, s1o = torch.empty_like(ph_re), torch.empty_like(ph_im)
    ck(lib.old_modal_profile(c.data_ptr(), sn.data_ptr(), ph_re.data_ptr(), ph_im.data_ptr(),
                             s0o.data_ptr(), s1o.data_ptr(), part.data_ptr(), o.data_ptr(),
                             m, s, t, prof.data_ptr(), stream()), "old profile")
    pr = prof.view(-1, 8).cpu().numpy().astype(np.float64) / max_mhz
    print(f"phases old partials kernel ({old_blocks} blocks x 8 warps; mean us a warp): "
          + ", ".join(f"{n} {pr[:, q_].mean():.2f}" for q_, n in enumerate(OLD_PHASES))
          + f"; total {pr[:, 6].mean():.2f} (max {pr[:, 6].max():.2f})")

    prof = torch.zeros(cap * 32 * 8, dtype=torch.int64, device=dev)
    ck(plib.modal_prof_set(prof.data_ptr()), "modal_prof_set")
    new("rot", c, sn, ph_re, ph_im, s, t, use=plib)
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    a.record()
    new("rot", c, sn, ph_re, ph_im, s, t, use=plib)
    e.record()
    torch.cuda.synchronize()
    pr = prof.view(-1, 8).cpu().numpy().astype(np.float64) / max_mhz
    rot = pr[:, 3] > 0
    folders = (pr[:, 5] > 0) & ~rot
    print(f"phases shipped kernel, profiled build ({a.elapsed_time(e):.4f} ms with the "
          f"reduce; {cap} blocks, {int(rot.sum())} rotation warps, {int(folders.sum())} "
          "fold warps; mean us a rotation warp): "
          + ", ".join(f"{n} {pr[rot, q_ + 1].mean():.2f}" for q_, n in enumerate(NEW_PHASES)
                      if q_ not in (3, 4))
          + f"; total {pr[rot, 0].mean():.2f} (max {pr[:, 0].max():.2f}); a fold warp: "
          f"full wait {pr[folders, 4].mean():.2f}, fold + partial {pr[folders, 5].mean():.2f}, "
          f"total {pr[folders, 0].mean():.2f}")
    print(f"card: {sh(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'])[1].strip()}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
