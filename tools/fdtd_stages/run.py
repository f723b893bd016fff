"""Measure the FDTD3D kernels' redesign (the cluster route) on one CUDA device.

    python3 tools/fdtd_stages/run.py [--out DIR]

Builds ``stages.cu`` (beside this file; it includes
``gpuaudiobench_tpu_torch/csrc/fdtd3d.cu``) twice with nvcc, one process
each, started together: plain and ``-DFDTD_PROFILE``. Prints, one line
each:

* the card (``nvidia-smi`` name, power limit, max SM clock) and toolchain;
* first, whether clusters of 2, 4, 8 and 16 blocks of 1,024 threads are
  schedulable at the shared memory each form's cluster layout needs at
  room 50 (the divergence form's kernel, the field form's two-phase
  design) and at the 232,448 bytes a block can opt into
  (``cudaOccupancyMaxActiveClusters``), and for the shipped cluster
  kernel at room 50 on 16 and 8 blocks;
* ``ptxas -v`` registers, spills and shared memory of every kernel;
* from ``cuobjdump -sass``, the instruction mix of the substep loop of the
  shipped cluster kernel and of the two-phase field design at room 50's
  build (9 cells a thread);
* the cluster barrier alone (us, 1,536 in one launch) at 2, 4, 8 and 16
  blocks, beside the grid barrier at room 50's and room 82's cooperative
  grids;
* bit-for-bit checks, fields chained over 2 blocks, at rooms 1, 8, 15
  (ragged ranges) and 50, with S odd, a receiver on the source cell and
  on a range boundary, and 128 per-track receivers: the cluster kernel
  against the twin, the cooperative kernel and a rerun (also on 8 blocks
  at room 50), and the two-phase field design against the twin, the
  shipped field kernel and a rerun;
* CUDA-event times at room 50, 128 tracks x 512 samples, in turns: the
  divergence form's cooperative kernel, the cluster kernel on 16 and 8
  blocks, without its hand-offs, and its first design (a cluster barrier
  a substep, checked bit for bit first); the shipped field kernel and the
  two-phase design with and without its hand-offs;
* clock64() phase sums per warp of the cluster kernel and the two-phase
  design at that shape.

The designs that ship in no kernel live in ``stages.cu``. Needs one CUDA
device, nvcc and cuobjdump (``$CUDA_HOME`` or ``/usr/local/cuda``).
``--out`` (default ``build/fdtd_stages``, which git ignores) receives
ptxas.txt and the SASS of both.
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
from gpuaudiobench_tpu_torch.ops import fdtd3d as fops  # noqa: E402
from gpuaudiobench_tpu_torch.utils.build import NVCC_FLAGS, nvcc_path  # noqa: E402

ROOM, S, TRACKS = 50, 512, 128
CHECKS = [(1, 7), (8, 64), (15, 9), (50, 33)]  # (room, samples)
SYNCS = 1536
BUILDS = {"plain": ["-Xptxas", "-v"], "prof": ["-DFDTD_PROFILE"]}
PHASES = {1: "prologue", 2: "stencil / faces", 6: "p update (field)",
          3: "wait", 4: "receivers", 7: "epilogue"}
SASS = {"cluster kernel": r"fdtd_div_cluster_kernelILi9E",
        "two-phase field design": r"two_phase_field_kernelILi9ELb1E"}


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
    """The two libraries, one nvcc each, started together."""
    tmp = Path(tempfile.mkdtemp())
    src = str(HERE / "stages.cu")
    jobs = {}
    for name, extra in BUILDS.items():
        lib = tmp / f"stages_{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(lib), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    for name, (lib, proc) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            print(logs[name][-6000:])
            raise SystemExit(f"nvcc failed for the {name} build")
    (out / "ptxas.txt").write_text(logs["plain"])
    return {name: lib for name, (lib, _) in jobs.items()}, logs["plain"]


def use(lib):
    """Routes the ops module's launches to ``lib``."""
    fops.bind(lib)
    fops._lib = lambda: lib


def bind_designs(lib):
    """Argument types of stages.cu's own entry points."""
    ip, i, f, p = (ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p)
    fops.bind(lib)
    for name in ("barrier_div_launch", "no_handoff_div_launch"):
        getattr(lib, name).argtypes = lib.fdtd_div_cluster_launch.argtypes
        getattr(lib, name).restype = i
    lib.two_phase_field_launch.argtypes = ([p] * 11 + [i] * 5 + [f] * 4
                                           + [ip, i, i, p])
    lib.two_phase_field_launch.restype = i
    lib.two_phase_field_smem.argtypes = [i, ip, i]
    lib.two_phase_field_smem.restype = ctypes.c_longlong
    lib.fdtd_prof_set.argtypes = [p]
    lib.fdtd_prof_set.restype = i


def geometry(room):
    n = fops.grid_n(room)
    return n, fops.source_pos(room), fops.receiver_pos(room)


def blocks_for(n):
    """The schedule's cluster size: the largest power of two up to 16
    and n."""
    b = fops.MAX_CLUSTER_BLOCKS
    while b > n:
        b //= 2
    return b


def balanced(n, blocks):
    """Balanced ranges of an n^3 grid on ``blocks`` blocks, as the C
    entry points take them."""
    cells = n ** 3
    return (ctypes.c_int * (blocks + 1))(
        *(b * cells // blocks for b in range(blocks + 1)))


def stream():
    return torch.cuda.current_stream().cuda_stream


def div_design(lib, name, x, p, div, n, src, rcv, blocks):
    """A divergence-form entry point of ``lib`` with
    fdtd_div_cluster_launch's arguments: (out, p', div')."""
    tracks, s = x.shape
    outs = [torch.empty_like(p), torch.empty_like(div),
            torch.empty((tracks, s), device=x.device)]
    err = getattr(lib, name)(
        fops.source_row(x).data_ptr(), p.data_ptr(), div.data_ptr(),
        *(o.data_ptr() for o in outs), n, s, fops.flat_cell(src, n), tracks,
        fops.flat_cell(rcv, n), fops.K1, fops.K2, fops.C6, fops.ABSORB,
        fops.F_OUTPUT_SCALE, balanced(n, blocks), blocks, stream())
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    return outs[2], outs[0], outs[1]


def two_phase(lib, x, p, vx, vy, vz, n, src, rcv, receivers=None,
              exchange=True):
    """The two-phase field design on the schedule's cluster size: (out,
    p', vx', vy', vz')."""
    tracks, s = x.shape
    blocks = blocks_for(n)
    fields = [torch.empty_like(t) for t in (p, vx, vy, vz)]
    out = torch.empty((tracks, s), device=x.device)
    err = lib.two_phase_field_launch(
        fops.source_row(x).data_ptr(), p.data_ptr(), vx.data_ptr(),
        vy.data_ptr(), vz.data_ptr(), *(f.data_ptr() for f in fields),
        out.data_ptr(), None if receivers is None else receivers.data_ptr(),
        n, s, fops.flat_cell(src, n), tracks, fops.flat_cell(rcv, n), fops.K1,
        fops.K2, fops.ABSORB, fops.F_OUTPUT_SCALE, balanced(n, blocks),
        blocks, int(exchange), stream())
    if err != 0:
        raise RuntimeError(f"two_phase_field_launch: CUDA error {err}")
    return (out, *fields)


def x_of(tracks, s, dev, seed=3):
    g = np.random.Generator(np.random.MT19937(seed))
    x = (g.random((tracks, s), dtype=np.float32) * 2 - 1).astype(np.float32)
    return torch.from_numpy(x).to(dev)


def line_cells(n, tracks, dev):
    xs, ys, zs = fops.receiver_line(tracks, n)
    cells = (xs.astype(np.int64) * n + ys) * n + zs
    return torch.from_numpy(cells.astype(np.int32)).to(dev)


def median_ms(fn, reps=10, calls=3):
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


def same(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b))


def check(lib, room, s, dev, rcv=None, per_track=False, blocks=None):
    """Over 2 chained blocks, bit for bit: the cluster kernel (on
    ``blocks`` blocks, by default the schedule's) against the twin, the
    cooperative kernel and a rerun; unless ``blocks`` is given, the
    two-phase field design against the twin, the shipped field kernel and
    a rerun. Returns (all equal, a line)."""
    n, src, rcv0 = geometry(room)
    rcv = rcv0 if rcv is None else rcv
    tracks = TRACKS if per_track else 4
    x = x_of(tracks, s, dev)
    cells = line_cells(n, tracks, dev) if per_track else None
    forms = {}
    if not per_track:
        forms["div"] = (
            fops.zero_fields_div,
            (lambda f: fops.fdtd3d_block_div_cluster(x, *f, src, rcv))
            if blocks is None else
            (lambda f: div_design(lib, "fdtd_div_cluster_launch", x, *f, n,
                                  src, rcv, blocks)),
            lambda f: fops.fdtd3d_block_div_coop(x, *f, src, rcv),
            lambda f: fops.fdtd3d_block_div_plain(x, *f, src, rcv))
    if blocks is None:
        forms["two-phase field"] = (
            fops.zero_fields,
            lambda f: two_phase(lib, x, *f, n, src, rcv, cells),
            lambda f: fops.fdtd3d_block_field(x, *f, src, rcv,
                                              receivers=cells),
            lambda f: fops.fdtd3d_block_field_plain(x, *f, src, rcv,
                                                    receivers=cells))
    res = {}
    for form, (zero, clu, shipped, twin) in forms.items():
        fc = fo = fp = fr = zero(n, dev)
        ok = {"twin": True, "shipped": True, "rerun": True}
        for _ in range(2):
            rc, ro, rp, rr = clu(fc), shipped(fo), twin(fp), clu(fr)
            ok["twin"] &= same(rc, rp)
            ok["shipped"] &= same(rc, ro)
            ok["rerun"] &= same(rc, rr)
            fc, fo, fp, fr = rc[1:], ro[1:], rp[1:], rr[1:]
        res[form] = ok
    torch.cuda.synchronize()
    good = all(all(v.values()) for v in res.values())
    return good, (f"check room {room} S={s} rcv {rcv}"
                  + (f", {tracks} per-track receivers" if per_track else "")
                  + (f", {blocks} blocks" if blocks else "") + ": "
                  + "; ".join(f"{f} " + ", ".join(
                      f"{k} {'=' if v else 'DIFFERS'}" for k, v in ok.items())
                      for f, ok in res.items()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(REPO / "build" / "fdtd_stages"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
              "--format=csv,noheader"])[1].strip()
    print(f"card: {smi}", flush=True)
    max_mhz = float(smi.split(",")[-1].split()[0])
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.time()
    paths, log = build(out_dir)
    print(f"build: two libraries in {time.time() - t0:.1f} s", flush=True)
    libs = {k: ctypes.CDLL(str(v)) for k, v in paths.items()}
    for lib in libs.values():
        bind_designs(lib)
    plain = libs["plain"]
    use(plain)
    dev = torch.device("cuda:0")
    n = fops.grid_n(ROOM)

    # Schedulability first: it decides the field form's layout.
    for blocks in (2, 4, 8, 16):
        sizes = {f"div room {ROOM}": fops.cluster_smem_bytes(
                     n, -(-n ** 3 // blocks)),
                 f"two-phase field room {ROOM}": plain.two_phase_field_smem(
                     n, balanced(n, blocks), blocks),
                 "opt-in max": fops.SMEM_PER_BLOCK}
        print(f"clusters of {blocks} x 1024 threads schedulable at once: "
              + ", ".join(f"{k} ({v:,} B) "
                          + (str(fops.cluster_occupancy(blocks, v, dev))
                             if v <= fops.SMEM_PER_BLOCK else "over the limit")
                          for k, v in sizes.items()))
    for blocks in (16, 8):
        starts = balanced(n, blocks)
        print(f"shipped cluster kernel, room {ROOM}, {blocks} blocks of "
              f"{plain.fdtd_cluster_smem(n, starts, blocks):,} B: "
              f"{plain.fdtd_cluster_occupancy(n, starts, blocks)} clusters "
              "at once")
    plan = fops.fdtd_schedule(n, "div")
    print(f"schedule room {ROOM}: div {plan.route} on {plan.blocks} blocks "
          f"of {plan.smem_bytes:,} B, field "
          f"{fops.fdtd_schedule(n, 'field').route}")

    fn = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
        if fn and ("Used" in ln or "spill" in ln):
            short = re.sub(r"^_Z\d+", "", fn)[:48]
            print(f"ptxas {short}: {ln.split(':', 1)[-1].strip()}")
    _, sass = sh([str(Path(nvcc_path()).with_name("cuobjdump")), "-sass",
                  str(paths["plain"])])
    for label, pat in SASS.items():
        name, loops = hot_loops(sass, pat, "LDS")
        for blk in re.split(r"\n\s+Function : ", sass)[1:]:
            if blk.split("\n", 1)[0].strip() == name:
                (out_dir / f"sass_{label.split()[0]}.txt").write_text(blk)
        if loops:
            top = max(loops, key=lambda c: c["LDS"])  # the substep loop
            print(f"sass {label}, 9 cells a thread: substep loop "
                  f"{sum(top.values())} instructions, "
                  f"{sum(top.values()) / 9:.1f} a cell: "
                  + ", ".join(f"{k} {v}" for k, v in top.most_common(18)),
                  flush=True)

    # The barriers alone.
    for blocks in (2, 4, 8, 16):
        ms = median_ms(lambda: fops.cluster_probe(blocks, plan.smem_bytes,
                                                  SYNCS, dev), 5, 2)
        print(f"cluster barrier alone, {blocks} blocks x 1024 threads, "
              f"{plan.smem_bytes:,} B each: {ms / SYNCS * 1e3:.4f} us each "
              f"({SYNCS} in {ms:.4f} ms)")
    smem_f = plain.two_phase_field_smem(n, balanced(n, 16), 16)
    ms = median_ms(lambda: fops.cluster_probe(16, smem_f, SYNCS, dev), 5, 2)
    print(f"cluster barrier alone, 16 blocks, {smem_f:,} B each: "
          f"{ms / SYNCS * 1e3:.4f} us each")
    for room in (ROOM, 82):
        m = fops.grid_n(room)
        ms = median_ms(lambda: fops.sync_probe(m, SYNCS, dev), 5, 2)
        print(f"grid barrier alone, room {room}'s cooperative grid "
              f"({plain.fdtd_div_blocks(m)} blocks of 512): "
              f"{ms / SYNCS * 1e3:.4f} us each", flush=True)

    ok = True
    cases = [dict(room=r, s=s) for r, s in CHECKS]
    n8 = fops.grid_n(8)
    edge = fops.fdtd_schedule(n8, "div").ranges[1][0]  # a range boundary
    cases += [dict(room=8, s=12, rcv=fops.source_pos(8)),
              dict(room=8, s=12, rcv=(edge // (n8 * n8), edge // n8 % n8,
                                      edge % n8)),
              dict(room=ROOM, s=16, per_track=True),
              dict(room=ROOM, s=16, blocks=8)]
    for case in cases:
        good, text = check(plain, dev=dev, **case)
        ok = ok and good
        print(text, flush=True)

    x = x_of(TRACKS, S, dev)
    cells = line_cells(n, TRACKS, dev)
    _, src, rcv = geometry(ROOM)
    zd, zf = fops.zero_fields_div(n, dev), fops.zero_fields(n, dev)

    xs = x[:, :33].contiguous()
    a = div_design(plain, "barrier_div_launch", xs, *zd, n, src, rcv, 16)
    b = fops.fdtd3d_block_div_cluster(xs, *zd, src, rcv)
    good = same(a, b)
    ok = ok and good
    print(f"check first design vs shipped cluster kernel, room {ROOM} S=33: "
          f"{'=' if good else 'DIFFERS'}")

    def div(route, blocks=16):
        def run():
            if route == "coop":
                fops.fdtd3d_block_div_coop(x, *zd, src, rcv)
            elif route == "cluster":
                fops.fdtd3d_block_div_cluster(x, *zd, src, rcv)
            else:
                div_design(plain, route, x, *zd, n, src, rcv, blocks)
        return run

    def field(route, lib=plain):
        def run():
            if route == "shipped":
                fops.fdtd3d_block_field(x, *zf, src, rcv, receivers=cells)
            else:
                two_phase(lib, x, *zf, n, src, rcv, cells,
                          exchange=route == "two-phase")
        return run

    for form, order in (
            ("div", [("coop", div("coop")), ("cluster 16", div("cluster")),
                     ("cluster 8", div("fdtd_div_cluster_launch", 8)),
                     ("cluster 16 no hand-off", div("no_handoff_div_launch")),
                     ("first design", div("barrier_div_launch")),
                     ("cluster 16", div("cluster")), ("coop", div("coop"))]),
            ("field", [("shipped (cooperative)", field("shipped")),
                       ("two-phase 16", field("two-phase")),
                       ("two-phase 16 no hand-off", field("no hand-off")),
                       ("two-phase 16", field("two-phase")),
                       ("shipped (cooperative)", field("shipped"))])):
        times = {}
        for label, fn in order:
            times.setdefault(label, []).append(median_ms(fn))
        print(f"times {form} room {ROOM}, {TRACKS}x{S} (ms, CUDA events, median "
              "of 10 x 3 calls): " + "; ".join(
                  f"{k} " + " / ".join(f"{v:.4f}" for v in vs)
                  for k, vs in times.items()), flush=True)

    warps = 16 * 32
    prof = torch.zeros(warps * 8, dtype=torch.int64, device=dev)
    prof_lib = libs["prof"]

    def div_prof():
        use(prof_lib)
        try:
            fops.fdtd3d_block_div_cluster(x, *zd, src, rcv)
        finally:
            use(plain)

    for form, fn in (("cluster kernel", div_prof),
                     ("two-phase field design", field("two-phase", prof_lib))):
        prof.zero_()
        if prof_lib.fdtd_prof_set(prof.data_ptr()) != 0:
            raise RuntimeError("fdtd_prof_set failed")
        ms = median_ms(fn, 3, 1)
        pr = prof.view(-1, 8).cpu().numpy().astype(np.float64) / max_mhz
        print(f"phases {form}, profiled build ({ms:.4f} ms; {warps} warps; "
              "mean us a warp): "
              + ", ".join(f"{name} {pr[:, q].mean():.2f}" for q, name in PHASES.items()
                          if pr[:, q].any())
              + f"; total {pr[:, 0].mean():.2f} (max {pr[:, 0].max():.2f})")
    print(f"all checks bit for bit: {ok}")
    print(f"card: {sh(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'])[1].strip()}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
