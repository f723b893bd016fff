"""Environment check: is this machine ready to give the port's numbers,
and if not, which part is broken?

The port's copy of the repo-level ``tools/doctor.py``, with checks for
the card and the port's builds:

* device: the CUDA device (its name, count and power limit), probed in
  a SUBPROCESS with a timeout (``--probe-timeout``), so a wedged driver
  cannot hang the doctor itself; with ``--device cpu``, that torch
  imports and runs there;
* nvcc: found (``utils/build.nvcc_path``), and the kernels' build
  directory writable;
* pacer: the native g++ DAW-sim pacer builds (``utils/native.build``;
  the Python pacer stands in where it does not);
* peaks: ``utils/measured_peaks.json`` present and naming the card and
  power limit that nvidia-smi reports (the rooflines divide by them).

On the CPU, what only the card needs (nvcc, the peaks' card) warns
instead of failing.

Usage: python -m gpuaudiobench_tpu_torch.tools.doctor
           [--probe-timeout SECONDS] [--device cuda|cpu]
Exit code: 0 = all checks passed or only warned; 1 = a check failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import List, Optional, Tuple

OK, WARN, FAIL = "ok", "warn", "FAIL"

PROBE = {
    "cuda": ("import json, torch\n"
             "assert torch.cuda.is_available(), "
             "'torch.cuda.is_available() is False'\n"
             "x = torch.ones(1 << 20, device='cuda:0')\n"
             "assert float(x.sum()) == float(1 << 20)\n"
             "print(json.dumps({'kind': torch.cuda.get_device_name(0), "
             "'n': torch.cuda.device_count(), 'version': torch.version.cuda}))"),
    "cpu": ("import json, torch\n"
            "x = torch.ones(1 << 20)\n"
            "assert float(x.sum()) == float(1 << 20)\n"
            "print(json.dumps({'kind': 'cpu', 'n': 1, "
            "'version': torch.__version__}))"),
}

Row = Tuple[str, str, str]


def _report(rows: List[Row], code: int) -> int:
    width = max(len(r[1]) for r in rows)
    for status, name, detail in rows:
        mark = {OK: "+", WARN: "!", FAIL: "x"}[status]
        print(f" [{mark}] {name.ljust(width)}  {detail}")
    print("doctor:", "healthy" if code == 0 else "NOT healthy")
    return code


def probe_device(device: str, timeout_s: float):
    """(status, detail, kind): a child process imports torch and runs a
    reduction on ``device``, so a wedged driver cannot hang the doctor."""
    try:
        r = subprocess.run([sys.executable, "-c", PROBE[device]],
                           capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return (FAIL,
                f"no answer in {timeout_s:g} s -- the driver is wedged, or "
                "another process holds the card", None)
    if r.returncode != 0:
        return (FAIL, (r.stderr.strip().splitlines() or ["probe failed"])[-1],
                None)
    try:
        info = json.loads(r.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return (FAIL, f"unparseable probe output: {r.stdout[:120]!r}", None)
    if device == "cpu":
        return OK, f"cpu (torch {info['version']})", info["kind"]
    return (OK, f"{info['n']}x {info['kind']} (CUDA {info['version']})",
            info["kind"])


def check_nvcc(device: str) -> Row:
    from gpuaudiobench_tpu_torch.utils import build

    miss = FAIL if device == "cuda" else WARN
    try:
        nvcc = build.nvcc_path()
    except RuntimeError as e:
        return miss, "nvcc", f"{e}" + (
            "" if device == "cuda" else " (CPU runs use the plain twins)")
    try:
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=build.BUILD_DIR):
            pass
    except OSError as e:
        return FAIL, "nvcc", f"{nvcc}; build dir {build.BUILD_DIR} not " \
            f"writable: {e}"
    return OK, "nvcc", f"{nvcc}; builds to {build.BUILD_DIR}"


def check_pacer() -> Row:
    from gpuaudiobench_tpu_torch.utils import native

    try:
        return OK, "native pacer", str(native.build())
    except RuntimeError as e:
        return (WARN, "native pacer",
                f"{str(e).splitlines()[0]} -- DAW-sim runs the Python "
                "pacer")


def check_peaks(device: str, kind: Optional[str]) -> Row:
    from gpuaudiobench_tpu_torch.utils.device import nvidia_smi_identity
    from gpuaudiobench_tpu_torch.utils.roofline import MEASURED_PEAKS_PATH

    if not os.path.exists(MEASURED_PEAKS_PATH):
        return (WARN, "peak calibration",
                "no measured_peaks.json -- rooflines divide by the data "
                "sheet (run python -m gpuaudiobench_tpu_torch.calibrate_peaks "
                "on the card)")
    with open(MEASURED_PEAKS_PATH) as f:
        peaks = json.load(f)
    have = f"{peaks.get('device_kind')}, {peaks.get('power_limit')}"
    if device == "cpu":
        return OK, "peak calibration", f"for {have} (a CPU run uses none)"
    if kind is None:
        return WARN, "peak calibration", "device unreachable; cannot match " \
            f"the calibration for {have}"
    line = nvidia_smi_identity()
    if line is None:
        return (WARN, "peak calibration",
                f"nvidia-smi gave no name and power limit to match {have}")
    name, limit = (part.strip() for part in line.rsplit(",", 1))
    if (name, limit) != (peaks.get("device_kind"), peaks.get("power_limit")):
        return (WARN, "peak calibration",
                f"calibrated on {have}, this card is {name}, {limit} -- "
                "rerun python -m gpuaudiobench_tpu_torch.calibrate_peaks")
    return OK, "peak calibration", f"{have}, as nvidia-smi reports"


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe-timeout", type=float, default=120.0)
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    status, detail, kind = probe_device(args.device, args.probe_timeout)
    rows = [(status, "device", detail), check_nvcc(args.device),
            check_pacer(), check_peaks(args.device, kind)]
    return _report(rows, 1 if any(r[0] == FAIL for r in rows) else 0)


if __name__ == "__main__":
    raise SystemExit(main())
