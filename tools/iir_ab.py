"""The IIR scan and block-state kernels of two checkouts, in one process.

    python3 tools/iir_ab.py OTHER_CHECKOUT

Builds ``gpuaudiobench_tpu_torch/csrc/iir.cu`` of this checkout and of
OTHER_CHECKOUT (e.g. a ``git archive`` of the parent commit unpacked
under ``build/``) with nvcc, one process each, started together, and
prints, for ``iir_biquad_kernel`` and ``iir_blockstate_kernel<16>`` (the
m = 128 instance):

* whether the two builds' SASS (``cuobjdump -sass``) is the same,
  instruction for instruction;
* whether their outputs and states are bit for bit the same on
  ``chip_smoke.py``'s inputs at 65,536 x 512;
* CUDA-event times of each build's launch in turns (other, this, this,
  other, three times), back to back as ``chip_smoke.py`` times them and
  behind a ~1 ms spin.

A kernel whose SASS and device time match while ``chip_smoke.py``'s A/B
reads them apart was moved by what ran before it in the script, not by
its code. Needs one CUDA device, nvcc and cuobjdump.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402
from gpuaudiobench_tpu_torch.harness.device_timing import spin_cycles_per_ms  # noqa: E402
from gpuaudiobench_tpu_torch.ops import iir as iops  # noqa: E402
from gpuaudiobench_tpu_torch.utils.build import NVCC_FLAGS, nvcc_path  # noqa: E402

SOURCE = Path("gpuaudiobench_tpu_torch") / "csrc" / "iir.cu"
KERNELS = {"iir_biquad": "iir_biquad_kernel", "iir_biquad_blockstate":
           "iir_blockstate_kernelILi16E"}
TRACKS, S, BLOCK_M = 65536, 512, 128


def sass_of(lib: Path, name: str):
    """The kernel's SASS instructions, addresses and encodings dropped."""
    cuobjdump = str(Path(nvcc_path()).with_name("cuobjdump"))
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    for block in out.split("Function : ")[1:]:
        if name in block.split("\n", 1)[0]:
            return [ln.split("*/", 1)[1].split("/*")[0].strip()
                    for ln in block.splitlines() if ln.strip().startswith("/*0")]
    raise SystemExit(f"no {name} in {lib}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    tmp = Path(tempfile.mkdtemp())
    roots = {"other": Path(args.other).resolve(), "this": REPO}
    jobs = {k: subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp / f"{k}.so"),
                                 str(root / SOURCE)]) for k, root in roots.items()}
    if any(p.wait() != 0 for p in jobs.values()):
        raise SystemExit("nvcc failed")
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for k in roots:
        lib = ctypes.CDLL(str(tmp / f"{k}.so"))
        lib.iir_biquad_launch.argtypes = [p] * 5 + [i] * 2 + [p]
        lib.iir_blockstate_launch.argtypes = [p] * 7 + [i] * 3 + [p]
        libs[k] = lib

    dev = torch.device("cuda:0")
    x, c, z = cs.iir_inputs(torch, TRACKS, S, dev)
    taps, u = cs.blockstate_tables(torch, iops, c, S, BLOCK_M, dev)
    m = taps.shape[0]

    def launch(kernel, k):
        y, zo = torch.empty_like(x), torch.empty_like(z)
        st = torch.cuda.current_stream().cuda_stream
        if kernel == "iir_biquad":
            err = libs[k].iir_biquad_launch(x.data_ptr(), c.data_ptr(), z.data_ptr(),
                                            y.data_ptr(), zo.data_ptr(), TRACKS, S, st)
        else:
            err = libs[k].iir_blockstate_launch(
                x.data_ptr(), c.data_ptr(), taps.data_ptr(), u.data_ptr(), z.data_ptr(),
                y.data_ptr(), zo.data_ptr(), TRACKS, S, m, st)
        if err != 0:
            raise RuntimeError(f"{kernel} ({k}): CUDA error {err}")
        return y, zo

    cycles = spin_cycles_per_ms()

    def median_ms(fn, spin, reps=20, calls=10):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            if spin:
                torch.cuda._sleep(cycles)
            a.record()
            for _ in range(calls):
                fn()
            e.record()
            e.synchronize()
            ts.append(a.elapsed_time(e) / calls)
        return sorted(ts)[len(ts) // 2]

    for kernel, name in KERNELS.items():
        same_sass = sass_of(tmp / "other.so", name) == sass_of(tmp / "this.so", name)
        ya, za = launch(kernel, "other")
        yb, zb = launch(kernel, "this")
        same_out = torch.equal(ya, yb) and torch.equal(za, zb)
        print(f"{kernel}: SASS the same {same_sass}, outputs bit for bit {same_out}")
        for spin in (False, True):
            times = {"other": [], "this": []}
            for k in ["other", "this", "this", "other"] * 3:
                times[k].append(median_ms(lambda: launch(kernel, k), spin))
            print(f"{kernel} {'behind a spin' if spin else 'back to back'} (ms, median of "
                  "20 x 10 calls): " + "; ".join(
                      f"{k} " + " / ".join(f"{v:.4f}" for v in vs) for k, vs in times.items()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
