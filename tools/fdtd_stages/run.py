"""Measure the FDTD3D kernels' redesigns (cluster, plane routes) on one device.

    python3 tools/fdtd_stages/run.py [--out DIR] [--part all|div|field]

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
  build (9 cells a thread), and of the plane kernel at room 82's (7);
* the plane kernel's shared memory and co-resident blocks at rooms 66,
  82, 100 and 128;
* the cluster barrier alone (us, 1,536 in one launch) at 2, 4, 8 and 16
  blocks, beside the grid barrier at room 50's and room 82's field-kernel
  grids;
* bit-for-bit checks, fields chained over 2 blocks, at rooms 1, 8, 15
  (ragged ranges) and 50, with S odd, a receiver on the source cell and
  on a range boundary, and 128 per-track receivers: the cluster kernel
  against the twin, the plane kernel, the grid-sync kernel and a
  rerun (also on 8 blocks at room 50), and the two-phase field design
  against the twin, the shipped field kernel and a rerun; at rooms 66, 82
  and 128 the plane kernel against the twin, the grid-sync kernel and a
  rerun;
* CUDA-event times at room 50, 128 tracks x 512 samples, in turns: the
  divergence form's plane kernel, the cluster kernel on 16 and 8
  blocks, without its hand-offs, and its first design (a cluster barrier
  a substep, checked bit for bit first); the shipped field kernel and the
  two-phase design with and without its hand-offs;
* the pair design (clusters of two planes) and the plane kernel with its
  in-plane pair sums taken in the wait (``planes pre``) against the twin
  bit for bit at rooms 8, 81 (an odd count of planes), 66, 82 and 128;
* CUDA-event times behind a ~1 ms spin at rooms 66, 82, 100 and 128, 128
  tracks x 512 samples, in turns: the grid-sync kernel (the one the
  plane kernel replaced), the plane kernel, the plane kernel with its
  pair sums taken in the wait, the pair design, and the plane kernel's
  variants without the flag waits and without the exchange; then, for
  each of the grid-sync kernel and the plane kernel, the largest room
  whose block meets the 10.667 ms deadline (a bisection over rooms
  66-128);
* the same times of the cluster kernel and the plane kernel at rooms 8
  to 65, which the cluster route takes: where each route is the faster;
* clock64() phase sums per warp of the cluster kernel and the two-phase
  design at room 50, and of the plane kernel at rooms 66, 82, 100 and
  128.

The field form (``--part field``; ``--part div`` runs the above alone,
``all`` both):

* ptxas registers and spills of the field plane kernel's builds, and the
  SASS mix of its substep loop at 3 cells a thread (the upper faces in
  registers) and 7 (vy and vz in shared memory);
* its route, shared memory and co-resident blocks at rooms 8 to 128;
* bit-for-bit checks, fields chained over 2 blocks, with 128 per-track
  receivers (track 0 on the source cell) and the broadcast receiver, at
  rooms 1, 8, 15, 50, 66, 69, 70 (the layouts' edge), 82, 100 and 128:
  the route against the twin, the grid-stride kernel and a rerun, and
  the other layout (rooms up to 82) against the twin;
* CUDA-event times behind a ~1 ms spin, 128 per-track receivers x 512
  samples, in turns: the grid-stride kernel and the route at rooms 8,
  24, 40, 50, 66, 82, 100, 113 and 128, the other layout at rooms up to
  82, the plane kernel without its waits and without its exchange at
  rooms 50, 82 and 128; then the largest room whose block meets the
  10.667 ms deadline on the grid-stride kernel and on the route;
* clock64() phase sums per warp of the plane kernel at rooms 50, 82 and
  128.

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
PLANE_CHECKS = [(66, 5), (82, 7), (128, 4)]
PLANE_ROOMS = (66, 82, 100, 128)
PLANE_PROFILE = PLANE_ROOMS
CROSSOVER_ROOMS = (8, 16, 24, 32, 40, 50, 58, 65)
DEADLINE_MS = 512 / 48_000 * 1e3
SYNCS = 1536
BUILDS = {"plain": ["-Xptxas", "-v"], "prof": ["-DFDTD_PROFILE"]}
PHASES = {1: "prologue", 2: "stencil / faces", 6: "p update (field)",
          3: "wait", 4: "receivers", 7: "epilogue"}
SASS = {"cluster kernel": (r"fdtd_div_cluster_kernelILi9E", 9),
        "two-phase field design": (r"two_phase_field_kernelILi9ELb1E", 9),
        "plane kernel": (r"fdtd_div_planes_kernelILi7E", 7)}
FIELD_SASS = {
    "field plane kernel, registers": (
        r"fdtd_field_planes_kernelILi3ELb1ELb1ELb1E", 3),
    "field plane kernel, shared": (
        r"fdtd_field_planes_kernelILi7ELb0ELb1ELb1E", 7)}
FIELD_CHECKS = [(1, 5), (8, 12), (15, 7), (50, 9), (66, 5), (69, 4),
                (70, 4), (82, 7), (100, 4), (128, 3)]  # (room, samples)
FIELD_ROOMS = (8, 24, 40, 50, 66, 82, 100, 113, 128)
FIELD_OTHER_LAYOUT = 82  # the other layout is built up to this room
FIELD_CUT_ROOMS = (50, 82, 128)  # without the waits, without the exchange
FIELD_PROFILE = (50, 82, 128)


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
    lib.old_coop_div_launch.argtypes = [p] * 8 + [i] * 5 + [f] * 5 + [p]
    lib.old_coop_div_launch.restype = i
    lib.old_coop_div_blocks.argtypes = [i]
    lib.old_coop_div_blocks.restype = i
    lib.planes_variant_launch.argtypes = ([p] * 8 + [i] * 5 + [f] * 5
                                          + [ip, i, i, p])
    lib.planes_variant_launch.restype = i
    lib.planes_pair_launch.argtypes = lib.planes_variant_launch.argtypes
    lib.planes_pair_launch.restype = i
    lib.planes_pair_occupancy.argtypes = [i]
    lib.planes_pair_occupancy.restype = i
    lib.field_planes_variant_launch.argtypes = (
        [i, i] + lib.fdtd_field_planes_launch.argtypes)
    lib.field_planes_variant_launch.restype = i
    lib.old_field_launch.argtypes = [p] * 16 + [i] * 5 + [f] * 4 + [p]
    lib.old_field_launch.restype = i
    lib.old_field_blocks.argtypes = [i]
    lib.old_field_blocks.restype = i
    lib.fdtd_sync_probe_launch.argtypes = [i, i, p]
    lib.fdtd_sync_probe_launch.restype = i


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


def old_coop(lib, x, p, div, n, src, rcv):
    """The grid-sync kernel (the cooperative divergence kernel the plane
    kernel replaced): (out, p', div')."""
    tracks, s = x.shape
    pa, pb, d = (torch.empty_like(p) for _ in range(3))
    out = torch.empty((tracks, s), device=x.device)
    pre = torch.empty(1, device=x.device)
    err = lib.old_coop_div_launch(
        fops.source_row(x).data_ptr(), p.data_ptr(), div.data_ptr(),
        pa.data_ptr(), pb.data_ptr(), d.data_ptr(), out.data_ptr(),
        pre.data_ptr(), n, s, fops.flat_cell(src, n), tracks,
        fops.flat_cell(rcv, n), fops.K1, fops.K2, fops.C6, fops.ABSORB,
        fops.F_OUTPUT_SCALE, stream())
    if err != 0:
        raise RuntimeError(f"old_coop_div_launch: CUDA error {err}")
    return out, (pa if s % 2 == 0 else pb), d


def old_field(lib, x, p, vx, vy, vz, source, receiver, receivers=None):
    """The field form's grid-stride kernel (the one the plane kernel
    replaced), with fdtd3d_block_field's arguments: (out, p', vx', vy',
    vz')."""
    n = p.shape[0]
    tracks, s = x.shape
    pa, pb = torch.empty_like(p), torch.empty_like(p)
    vs = [(torch.empty_like(t), torch.empty_like(t)) for t in (vx, vy, vz)]
    out = torch.empty((tracks, s), device=x.device)
    src_pre = torch.empty(1, device=x.device)
    err = lib.old_field_launch(
        fops.source_row(x).data_ptr(), p.data_ptr(), vx.data_ptr(),
        vy.data_ptr(), vz.data_ptr(), pa.data_ptr(), pb.data_ptr(),
        *(b.data_ptr() for pair in vs for b in pair), out.data_ptr(),
        src_pre.data_ptr(),
        None if receivers is None else receivers.data_ptr(), n, s,
        fops.flat_cell(source, n), tracks, fops.flat_cell(receiver, n),
        fops.K1, fops.K2, fops.ABSORB, fops.F_OUTPUT_SCALE, stream())
    if err != 0:
        raise RuntimeError(f"old_field_launch: CUDA error {err}")
    last = 0 if s % 2 == 0 else 1
    return (out, (pa, pb)[last], vs[0][last], vs[1][last], vs[2][last])


def sync_probe(lib, n, syncs):
    """``syncs`` grid barriers alone, on the grid-stride field kernel's
    grid for an n^3 room."""
    err = lib.fdtd_sync_probe_launch(syncs, lib.old_field_blocks(n),
                                     stream())
    if err != 0:
        raise RuntimeError(f"fdtd_sync_probe_launch: CUDA error {err}")


PAIR_COOPERATIVE = [1]  # the pair design's launch; 0 once refused


def plane_variant(lib, mode, x, p, div, n, src, rcv):
    """The plane kernel without its waits (mode 1) or without the exchange
    too (mode 2): (out, p', div'), wrong; mode "pair": the pair design
    (clusters of two planes), launched cooperatively unless such a launch
    was refused once."""
    tracks, s = x.shape
    outs = [torch.empty_like(p), torch.empty_like(div),
            torch.empty((tracks, s), device=x.device)]
    xch = torch.empty(2 * (n + 2) * fops.plane_stride(n), device=x.device)
    flags = torch.empty(n * fops.PLANE_FLAG_STRIDE, dtype=torch.int32,
                        device=x.device)
    plan = fops.plane_schedule(n)

    def launch(name, last):
        return getattr(lib, name)(
            fops.source_row(x).data_ptr(), p.data_ptr(), div.data_ptr(),
            *(o.data_ptr() for o in outs), xch.data_ptr(), flags.data_ptr(),
            n, s, fops.flat_cell(src, n), tracks, fops.flat_cell(rcv, n),
            fops.K1, fops.K2, fops.C6, fops.ABSORB, fops.F_OUTPUT_SCALE,
            fops.range_starts(plan), plan.blocks, last, stream())

    if mode == "pair":
        err = launch("planes_pair_launch", PAIR_COOPERATIVE[0])
        if err != 0 and PAIR_COOPERATIVE[0]:
            print(f"pair design: the cooperative cluster launch was refused "
                  f"(CUDA error {err}); launching it plainly after "
                  "cudaOccupancyMaxActiveClusters", flush=True)
            PAIR_COOPERATIVE[0] = 0
            err = launch("planes_pair_launch", 0)
    else:
        err = launch("planes_variant_launch", mode)
    if err != 0:
        raise RuntimeError(f"plane design {mode}: CUDA error {err}")
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


def median_ms(fn, reps=10, calls=3, spin=False):
    """Median over reps of CUDA-event ms a call, ``calls`` back to back;
    with ``spin``, each rep behind a ~1 ms spin kernel, so that the events
    time the device alone."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(2_000_000)
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
    """Over 2 chained blocks, bit for bit: the divergence form's kernel
    for the room (the cluster kernel on ``blocks`` blocks, by default the
    schedule's, where the room fits a cluster, else the plane kernel)
    against the twin, the plane kernel, the grid-sync kernel and a
    rerun; where the room fits a cluster and ``blocks`` is not given, the
    two-phase field design against the twin, the shipped field kernel and
    a rerun. Returns (all equal, a line)."""
    n, src, rcv0 = geometry(room)
    rcv = rcv0 if rcv is None else rcv
    tracks = TRACKS if per_track else 4
    x = x_of(tracks, s, dev)
    cells = line_cells(n, tracks, dev) if per_track else None
    cluster = fops.fdtd_schedule(n, "div").route == "cluster"
    forms = {}

    def planes(f):
        return fops.fdtd3d_block_div_coop(x, *f, src, rcv)

    if not per_track:
        if not cluster:
            kern = planes
        elif blocks is None:
            def kern(f):
                return fops.fdtd3d_block_div_cluster(x, *f, src, rcv)
        else:
            def kern(f):
                return div_design(lib, "fdtd_div_cluster_launch", x, *f, n,
                                  src, rcv, blocks)
        others = {"twin": lambda f: fops.fdtd3d_block_div_plain(x, *f, src,
                                                                rcv),
                  "grid-sync kernel": lambda f: old_coop(lib, x, *f, n, src,
                                                         rcv)}
        if cluster:
            others["plane kernel"] = planes
        forms["div " + ("cluster" if cluster else "planes")] = (
            fops.zero_fields_div, kern, others)
    if blocks is None and cluster:
        forms["two-phase field"] = (
            fops.zero_fields,
            lambda f: two_phase(lib, x, *f, n, src, rcv, cells),
            {"twin": lambda f: fops.fdtd3d_block_field_plain(
                 x, *f, src, rcv, receivers=cells),
             "shipped": lambda f: fops.fdtd3d_block_field(
                 x, *f, src, rcv, receivers=cells)})
    res = {}
    for form, (zero, kern, others) in forms.items():
        mine = again = zero(n, dev)
        theirs = {k: zero(n, dev) for k in others}
        ok = dict.fromkeys(list(others) + ["rerun"], True)
        for _ in range(2):
            got, rerun = kern(mine), kern(again)
            ok["rerun"] &= same(got, rerun)
            for k, fn in others.items():
                want = fn(theirs[k])
                ok[k] &= same(got, want)
                theirs[k] = want[1:]
            mine, again = got[1:], rerun[1:]
        res[form] = ok
    torch.cuda.synchronize()
    good = all(all(v.values()) for v in res.values())
    return good, (f"check room {room} S={s} rcv {rcv}"
                  + (f", {tracks} per-track receivers" if per_track else "")
                  + (f", {blocks} blocks" if blocks else "") + ": "
                  + "; ".join(f"{f} " + ", ".join(
                      f"{k} {'=' if v else 'DIFFERS'}" for k, v in ok.items())
                      for f, ok in res.items()))


def deadline_room(fn_of_room, lo=66, hi=128):
    """The largest room in [lo, hi] whose 128 x 512 block meets the
    deadline, by bisection (the time grows with the room), or lo - 1;
    and {room: ms} of the rooms timed."""
    seen = {}

    def ms(room):
        if room not in seen:
            seen[room] = median_ms(fn_of_room(room), 3, 1, spin=True)
        return seen[room]

    if ms(lo) > DEADLINE_MS:
        return lo - 1, seen
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if ms(mid) <= DEADLINE_MS:
            lo = mid
        else:
            hi = mid - 1
    return lo, seen


def print_build(log, lib_path, out_dir, part):
    """ptxas lines and the SASS mix of the part's kernels."""
    fn = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
        if fn and ("Used" in ln or "spill" in ln) and (
                part == "all" or ("field_planes" in fn) == (part == "field")):
            short = re.sub(r"^_Z\d+", "", fn)[:64]
            print(f"ptxas {short}: {ln.split(':', 1)[-1].strip()}")
    _, sass = sh([str(Path(nvcc_path()).with_name("cuobjdump")), "-sass",
                  str(lib_path)])
    kernels = {**(SASS if part != "field" else {}),
               **(FIELD_SASS if part != "div" else {})}
    for label, (pat, cpt) in kernels.items():
        name, loops = hot_loops(sass, pat, "LDS")
        for blk in re.split(r"\n\s+Function : ", sass)[1:]:
            if blk.split("\n", 1)[0].strip() == name:
                (out_dir / f"sass_{label.replace(' ', '_').replace(',', '')}"
                 ".txt").write_text(blk)
        if loops:
            top = max(loops, key=lambda c: c["LDS"])  # the substep loop
            print(f"sass {label}, {cpt} cells a thread: substep loop "
                  f"{sum(top.values())} instructions, "
                  f"{sum(top.values()) / cpt:.1f} a cell: "
                  + ", ".join(f"{k} {v}" for k, v in top.most_common(18)),
                  flush=True)


def div_part(libs, dev, max_mhz):
    """The divergence form's measurements (and the field form's cluster
    design); returns whether every check was bit for bit."""
    plain = libs["plain"]
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
    for room in PLANE_ROOMS:
        m = fops.grid_n(room)
        pp = fops.fdtd_schedule(m, "div")
        print(f"schedule room {room}: div {pp.route} on {pp.blocks} blocks "
              f"of {pp.smem_bytes:,} B (C side {plain.fdtd_planes_smem(m):,}); "
              f"the card holds {plain.fdtd_planes_capacity(m)} at once; "
              f"the grid-sync kernel {plain.old_coop_div_blocks(m)} blocks "
              "of 512; "
              f"the pair design's clusters of 2 at once "
              f"{plain.planes_pair_occupancy(m)} (needs {-(-m // 2)})",
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
        ms = median_ms(lambda: sync_probe(plain, m, SYNCS), 5, 2)
        print(f"grid barrier alone, room {room}'s grid-stride field grid "
              f"({plain.old_field_blocks(m)} blocks of 512): "
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
    cases += [dict(room=r, s=s) for r, s in PLANE_CHECKS]
    for case in cases:
        good, text = check(plain, dev=dev, **case)
        ok = ok and good
        print(text, flush=True)
    for room, s in [(8, 12), (81, 7)] + PLANE_CHECKS:
        m, psrc, prcv = geometry(room)
        xr = x_of(4, s, dev)
        res = []
        for mode in ("pair", 3):
            f_var = f_twin = fops.zero_fields_div(m, dev)
            good = True
            for _ in range(2):
                got = plane_variant(plain, mode, xr, *f_var, m, psrc, prcv)
                want = fops.fdtd3d_block_div_plain(xr, *f_twin, psrc, prcv)
                good &= same(got, want)
                f_var, f_twin = got[1:], want[1:]
            torch.cuda.synchronize()
            ok = ok and good
            res.append(f"{'pair design' if mode == 'pair' else 'planes pre'}"
                       f" {'=' if good else 'DIFFERS'}")
        print(f"check room {room} S={s} vs twin: " + ", ".join(res),
              flush=True)

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
            if route == "planes":
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
            ("div", [("planes", div("planes")), ("cluster 16", div("cluster")),
                     ("cluster 8", div("fdtd_div_cluster_launch", 8)),
                     ("cluster 16 no hand-off", div("no_handoff_div_launch")),
                     ("first design", div("barrier_div_launch")),
                     ("cluster 16", div("cluster")),
                     ("planes", div("planes"))]),
            ("field", [("shipped (planes)", field("shipped")),
                       ("two-phase 16", field("two-phase")),
                       ("two-phase 16 no hand-off", field("no hand-off")),
                       ("two-phase 16", field("two-phase")),
                       ("shipped (planes)", field("shipped"))])):
        times = {}
        for label, fn in order:
            times.setdefault(label, []).append(median_ms(fn))
        print(f"times {form} room {ROOM}, {TRACKS}x{S} (ms, CUDA events, median "
              "of 10 x 3 calls): " + "; ".join(
                  f"{k} " + " / ".join(f"{v:.4f}" for v in vs)
                  for k, vs in times.items()), flush=True)

    # The plane route against its parent, behind a spin, in turns.
    def planes_fns(room):
        m, psrc, prcv = geometry(room)
        xr = x_of(TRACKS, S, dev)
        z = fops.zero_fields_div(m, dev)
        return {
            "grid-sync kernel": lambda: old_coop(plain, xr, *z, m, psrc,
                                                 prcv),
            "planes": lambda: fops.fdtd3d_block_div_coop(xr, *z, psrc, prcv),
            "planes no wait": lambda: plane_variant(plain, 1, xr, *z, m, psrc,
                                                    prcv),
            "planes no exchange": lambda: plane_variant(plain, 2, xr, *z, m,
                                                        psrc, prcv),
            "pairs": lambda: plane_variant(plain, "pair", xr, *z, m, psrc,
                                           prcv),
            "planes pre": lambda: plane_variant(plain, 3, xr, *z, m, psrc,
                                                prcv)}

    for room in PLANE_ROOMS:
        fns = planes_fns(room)
        order = ["grid-sync kernel", "planes", "planes pre", "pairs",
                 "planes no wait", "planes no exchange", "pairs",
                 "planes pre", "planes", "grid-sync kernel"]
        times = {}
        for label in order:
            times.setdefault(label, []).append(
                median_ms(fns[label], 5, 1, spin=True))
        print(f"times planes room {room}, {TRACKS}x{S} (ms, CUDA events "
              "behind a spin, median of 5): " + "; ".join(
                  f"{k} " + " / ".join(f"{v:.4f}" for v in vs)
                  for k, vs in times.items()), flush=True)
        del fns
        torch.cuda.empty_cache()
    for label in ("grid-sync kernel", "planes"):
        room, seen = deadline_room(lambda r: planes_fns(r)[label])
        print(f"deadline {DEADLINE_MS:.3f} ms at {TRACKS}x{S}: {label} meets "
              f"it up to room {room} (timed: " + ", ".join(
                  f"{r} {v:.4f}" for r, v in sorted(seen.items())) + ")",
              flush=True)

    for room in CROSSOVER_ROOMS:
        m, psrc, prcv = geometry(room)
        xr = x_of(TRACKS, S, dev)
        z = fops.zero_fields_div(m, dev)
        fns = {"cluster": lambda: fops.fdtd3d_block_div_cluster(xr, *z, psrc,
                                                                prcv),
               "planes": lambda: fops.fdtd3d_block_div_coop(xr, *z, psrc,
                                                            prcv)}
        times = {}
        for label in ("cluster", "planes", "planes", "cluster"):
            times.setdefault(label, []).append(
                median_ms(fns[label], 5, 1, spin=True))
        print(f"times routes room {room}, {TRACKS}x{S} (ms, behind a spin, "
              "median of 5): " + "; ".join(
                  f"{k} " + " / ".join(f"{v:.4f}" for v in vs)
                  for k, vs in times.items()), flush=True)

    warps = max(16, max(fops.grid_n(r) for r in PLANE_PROFILE)) * 32
    prof = torch.zeros(warps * 8, dtype=torch.int64, device=dev)
    prof_lib = libs["prof"]

    def profiled(fn):
        def run():
            use(prof_lib)
            try:
                fn()
            finally:
                use(plain)
        return run

    runs = [("cluster kernel", 16 * 32, profiled(
                lambda: fops.fdtd3d_block_div_cluster(x, *zd, src, rcv))),
            ("two-phase field design", 16 * 32, field("two-phase", prof_lib))]
    for room in PLANE_PROFILE:
        m, psrc, prcv = geometry(room)
        zr = fops.zero_fields_div(m, dev)
        runs.append((f"plane kernel room {room}", m * 32, profiled(
            lambda zr=zr, psrc=psrc, prcv=prcv: fops.fdtd3d_block_div_coop(
                x, *zr, psrc, prcv))))
    for form, nwarps, fn in runs:
        prof.zero_()
        if prof_lib.fdtd_prof_set(prof.data_ptr()) != 0:
            raise RuntimeError("fdtd_prof_set failed")
        ms = median_ms(fn, 3, 1)
        pr = prof[:nwarps * 8].view(-1, 8).cpu().numpy().astype(np.float64)
        pr /= max_mhz
        print(f"phases {form}, profiled build ({ms:.4f} ms; {nwarps} warps; "
              "mean us a warp): "
              + ", ".join(f"{name} {pr[:, q].mean():.2f}" for q, name in PHASES.items()
                          if pr[:, q].any())
              + f"; total {pr[:, 0].mean():.2f} (max {pr[:, 0].max():.2f})",
              flush=True)
    return ok


def field_variant(lib, reg_faces, mode, x, fields, n, src, rcv, cells):
    """A field plane build of stages.cu:field_planes_variant (the layout
    with the upper faces in registers or vy and vz in shared memory; mode
    1 without the waits, 2 without the exchange too): (out, p', vx', vy',
    vz')."""
    tracks, s = x.shape
    outs = [torch.empty_like(f) for f in fields]
    out = torch.empty((tracks, s), device=x.device)
    xch, flags = fops._plane_scratch(n, x)
    rows = order = starts = None
    if cells is not None:
        order, starts = fops._receiver_buckets(cells, n)
        rows, order = cells.data_ptr(), order.data_ptr()
    plan = fops.plane_schedule(n)  # the planes; the layout is the build's
    err = lib.field_planes_variant_launch(
        int(reg_faces), mode, fops.source_row(x).data_ptr(),
        *(f.data_ptr() for f in fields), *(o.data_ptr() for o in outs),
        out.data_ptr(), xch.data_ptr(), flags.data_ptr(), rows, order,
        starts, n, s, fops.flat_cell(src, n), tracks, fops.flat_cell(rcv, n),
        fops.K1, fops.K2, fops.ABSORB, fops.F_OUTPUT_SCALE,
        fops.range_starts(plan), plan.blocks, stream())
    if err != 0:
        raise RuntimeError(f"field plane build (registers {reg_faces}, mode "
                           f"{mode}): CUDA error {err}")
    return (out, *outs)


def field_cells(n, src, tracks, dev):
    """128 receivers along the line, track 0 on the source cell."""
    cells = line_cells(n, tracks, dev)
    cells[0] = fops.flat_cell(src, n)
    return cells


def shipped_layout(n):
    """Whether the route's build for an n^3 grid keeps the upper faces in
    registers."""
    return fops.cells_per_thread(n * n) <= fops.FIELD_REG_FACES_MAX_CPT


def field_part(libs, dev, max_mhz):
    """The field form's plane kernel: routes, checks, times, the deadline
    room and phases; returns whether every check was bit for bit."""
    plain, prof_lib = libs["plain"], libs["prof"]
    for room in FIELD_ROOMS:
        n = fops.grid_n(room)
        plan = fops.fdtd_schedule(n, "field")
        extra = ""
        if plan.route == "planes":
            extra = (f" on {plan.blocks} blocks of {plan.smem_bytes:,} B (C "
                     f"side {plain.fdtd_field_planes_smem(n):,}), "
                     f"{fops.cells_per_thread(n * n)} cells a thread, "
                     f"upper faces in "
                     f"{'registers' if shipped_layout(n) else 'shared memory'}"
                     f"; the card holds "
                     f"{plain.fdtd_field_planes_capacity(n)} at once")
        print(f"schedule field room {room}: {plan.route}{extra}; the "
              f"grid-stride kernel {plain.old_field_blocks(n)} blocks of 512",
              flush=True)

    ok = True
    for room, s in FIELD_CHECKS:
        n, src, rcv = geometry(room)
        for per_track in (True, False):
            tracks = TRACKS if per_track else 4
            x = x_of(tracks, s, dev)
            cells = field_cells(n, src, tracks, dev) if per_track else None
            kerns = {
                "twin": fops.fdtd3d_block_field_plain,
                "grid-stride": (lambda *a, **kw:
                                old_field(plain, *a, **kw)),
                "rerun": fops.fdtd3d_block_field}
            if room <= FIELD_OTHER_LAYOUT:
                kerns["other layout"] = (
                    lambda xx, *f, src=src, rcv=rcv, n=n, cells=cells:
                    field_variant(plain, not shipped_layout(n), 0, xx,
                                  list(f), n, src, rcv, cells))
            mine = fops.zero_fields(n, dev)
            theirs = {k: fops.zero_fields(n, dev) for k in kerns}
            res = dict.fromkeys(kerns, True)
            for _ in range(2):
                got = fops.fdtd3d_block_field(x, *mine, src, rcv,
                                              receivers=cells)
                for k, fn in kerns.items():
                    if k in ("twin", "grid-stride", "rerun"):
                        want = fn(x, *theirs[k], src, rcv, receivers=cells)
                    else:
                        want = fn(x, *theirs[k])
                    res[k] &= same(got, want)
                    theirs[k] = want[1:]
                mine = got[1:]
            torch.cuda.synchronize()
            ok = ok and all(res.values())
            print(f"check field room {room} S={s} "
                  f"({fops.fdtd_schedule(n, 'field').route}), "
                  + (f"{tracks} per-track receivers" if per_track
                     else "broadcast receiver") + ": "
                  + ", ".join(f"{k} {'=' if v else 'DIFFERS'}"
                              for k, v in res.items()), flush=True)

    def fns(room):
        n, src, rcv = geometry(room)
        x = x_of(TRACKS, S, dev)
        cells = field_cells(n, src, TRACKS, dev)
        z = fops.zero_fields(n, dev)
        out = {"grid-stride": lambda: old_field(
                   plain, x, *z, src, rcv, receivers=cells),
               "route": lambda: fops.fdtd3d_block_field(
                   x, *z, src, rcv, receivers=cells)}
        reg, variants = shipped_layout(n), {}
        if room <= FIELD_OTHER_LAYOUT:
            variants["other layout"] = (not reg, 0)
        if room in FIELD_CUT_ROOMS:
            variants["no wait"] = (reg, 1)
            variants["no exchange"] = (reg, 2)
        for label, (r, mode) in variants.items():
            out[label] = (lambda r=r, mode=mode: field_variant(
                plain, r, mode, x, z, n, src, rcv, cells))
        return out

    for room in FIELD_ROOMS:
        fn = fns(room)
        labels = list(fn)
        order = labels + labels[::-1]
        times = {}
        for label in order:
            times.setdefault(label, []).append(
                median_ms(fn[label], 5, 1, spin=True))
        print(f"times field room {room}, {TRACKS}x{S} per-track (ms, CUDA "
              "events behind a spin, median of 5): " + "; ".join(
                  f"{k} " + " / ".join(f"{v:.4f}" for v in vs)
                  for k, vs in times.items()), flush=True)
        del fn
        torch.cuda.empty_cache()
    for label in ("grid-stride", "route"):
        room, seen = deadline_room(lambda r: fns(r)[label], lo=8)
        print(f"deadline {DEADLINE_MS:.3f} ms at {TRACKS}x{S} per-track: "
              f"the {label} meets it up to room {room} (timed: " + ", ".join(
                  f"{r} {v:.4f}" for r, v in sorted(seen.items())) + ")",
              flush=True)
        torch.cuda.empty_cache()

    prof = torch.zeros(max(fops.grid_n(r) for r in FIELD_PROFILE) * 32 * 8,
                       dtype=torch.int64, device=dev)
    for room in FIELD_PROFILE:
        n, src, rcv = geometry(room)
        x = x_of(TRACKS, S, dev)
        cells = field_cells(n, src, TRACKS, dev)
        z = fops.zero_fields(n, dev)
        prof.zero_()
        if prof_lib.fdtd_prof_set(prof.data_ptr()) != 0:
            raise RuntimeError("fdtd_prof_set failed")
        use(prof_lib)
        try:
            ms = median_ms(lambda: fops.fdtd3d_block_field(
                x, *z, src, rcv, receivers=cells), 3, 1)
        finally:
            use(plain)
        nwarps = n * 32
        pr = prof[:nwarps * 8].view(-1, 8).cpu().numpy().astype(np.float64)
        pr /= max_mhz
        print(f"phases field plane kernel room {room}, profiled build "
              f"({ms:.4f} ms; {nwarps} warps; mean us a warp): "
              + ", ".join(f"{name} {pr[:, q].mean():.2f}"
                          for q, name in PHASES.items() if pr[:, q].any())
              + f"; total {pr[:, 0].mean():.2f} (max {pr[:, 0].max():.2f})",
              flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(REPO / "build" / "fdtd_stages"))
    ap.add_argument("--part", choices=("all", "div", "field"), default="all")
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
    print_build(log, paths["plain"], out_dir, args.part)
    ok = True
    if args.part != "field":
        ok = div_part(libs, dev, max_mhz) and ok
    if args.part != "div":
        ok = field_part(libs, dev, max_mhz) and ok
    print(f"all checks bit for bit: {ok}")
    print(f"card: {sh(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'])[1].strip()}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
