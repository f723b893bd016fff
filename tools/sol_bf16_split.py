"""Measure SOL_MXU_bf16's product split along K against its golden.

    python3 tools/sol_bf16_split.py [--splits 1 2 4 8]

The bf16 x bf16 -> f32 product of SOL_MXU_bf16 (4,096^3, the benchmark's
own operands and f32 golden, ``models/speedoflight.py``) is formed as a
sum of K-chunk products, for each split count:

* ``addmm``: ``torch.addmm(c, a_k, b_k, out_dtype=torch.float32)`` per
  chunk, cuBLAS adding the f32 C in its beta = 1 epilogue;
* ``mm+add``: ``torch.mm(a_k, b_k, out_dtype=torch.float32)`` per chunk,
  summed into C by a separate f32 add.

For each it prints the benchmark's full-verification result against its
1e-3 bar (outputs failing, max relative error) and the CUDA-event time of
one product (median of 20 x 5 calls), then the card's nvidia-smi name and
power limit. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from gpuaudiobench_tpu_torch.config import BenchConfig  # noqa: E402
from gpuaudiobench_tpu_torch.harness.validation import compare_rel  # noqa: E402
from gpuaudiobench_tpu_torch.registry import create_benchmark  # noqa: E402


def split_product(a, b, splits: int, form: str) -> torch.Tensor:
    k = a.shape[1] // splits
    c = None
    for i in range(splits):
        a_k, b_k = a[:, i * k:(i + 1) * k], b[i * k:(i + 1) * k]
        if c is None:
            c = torch.mm(a_k, b_k, out_dtype=torch.float32)
        elif form == "addmm":
            c = torch.addmm(c, a_k, b_k, out_dtype=torch.float32)
        else:
            c = c + torch.mm(a_k, b_k, out_dtype=torch.float32)
    return c


def median_ms(fn, reps=20, calls=5) -> float:
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / calls)
    return sorted(ts)[len(ts) // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--splits", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    bench = create_benchmark("SOL_MXU_bf16", BenchConfig(verification="full"), dev)
    bench.setup()
    a, b = bench._ra, bench._rb
    floor = bench.tolerance * float(np.abs(bench.golden).max())
    for splits in args.splits:
        for form in (("addmm", "mm+add") if splits > 1 else ("mm",)):
            try:
                out = split_product(a, b, splits, form)
            except (TypeError, RuntimeError, NotImplementedError) as e:
                print(f"split {splits} {form}: not available ({e})")
                continue
            v = compare_rel(out.cpu().numpy(), bench.golden, bench.tolerance,
                            mode="full", label="SOL_MXU_bf16", floor=floor)
            err = np.abs(out.double().cpu().numpy() - bench.golden)
            rel = err / np.maximum(np.abs(bench.golden), floor)
            ms = median_ms(lambda: split_product(a, b, splits, form))
            print(f"split {splits} {form}: passed {v.passed}, "
                  f"{int((rel > bench.tolerance).sum())} of {rel.size} outputs "
                  f"over {bench.tolerance:g}, max relative error "
                  f"{rel.max():.4g}, max abs error {err.max():.4g}, "
                  f"{ms:.4f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
