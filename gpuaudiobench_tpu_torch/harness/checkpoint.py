"""Streaming-state checkpoint/resume.

PyTorch counterpart of ``gpuaudiobench_tpu/harness/checkpoint.py``, with
its file format: a plain ``.npz`` holding one array a leaf of the stream
carry (``leaf_0000``, ``leaf_0001``, ...) and a JSON ``header`` (the
``FORMAT`` string, the benchmark, the leaf count, each leaf's shape and
dtype), written to a temporary file and moved into place with
``os.replace``. No pickle is written or read, and the carry's structure
is never stored: ``load_stream_state`` flattens the template carry that
a fresh ``stream_body()`` just returned and refuses the file unless the
leaf count, every leaf's shape and dtype, and the benchmark agree. A
checkpoint the JAX package wrote of the same carry loads here.

Leaf order is the flatten order of the port's carry (nested tuples and
lists, ``harness.graph.leaves``). Two kinds of leaf have no JAX
counterpart:

* a Python int (PartConv's ring head, the nupols phase) is stored as a
  0-d int64 array and restored as a Python int;
* a bfloat16 tensor is stored as its raw 16 bits with the header's dtype
  ``"bfloat16"``, the name the JAX package writes through ml_dtypes
  (``Tensor.numpy()`` refuses bfloat16; numpy reads either file's
  member as 2-byte raw data).

Restored tensors go to the template leaf's device.
"""

from __future__ import annotations

import json
import numbers
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from gpuaudiobench_tpu_torch.harness.graph import leaves, rebuild

FORMAT = "tpuaudiobench-stream-state-v1"
BF16 = "bfloat16"


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    if isinstance(leaf, numbers.Integral) and not isinstance(leaf, bool):
        return "int64"
    raise TypeError(f"checkpoint: a carry leaf of type {type(leaf).__name__} "
                    "has no stored form (tensors and ints only)")


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def _to_host(leaf) -> np.ndarray:
    """One leaf as the array the file stores (one copy to the host)."""
    if not isinstance(leaf, torch.Tensor):
        _dtype_name(leaf)  # refuses what is neither a tensor nor an int
        return np.asarray(int(leaf), np.int64)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view("V2")
    return t.numpy()


def save_stream_state(
    path: str,
    carry: Any,
    *,
    benchmark: str = "",
    extra: Optional[Dict[str, Any]] = None,
) -> int:
    """Persist a streaming carry to ``path`` (.npz); returns the number of
    leaves written. The write is atomic: a crash mid-save leaves the
    previous checkpoint intact."""
    flat = leaves(carry)
    host = [_to_host(leaf) for leaf in flat]
    header = {
        "format": FORMAT,
        "benchmark": benchmark,
        "n_leaves": len(host),
        "saved_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "leaves": [
            {"shape": list(_shape(leaf)), "dtype": _dtype_name(leaf)}
            for leaf in flat
        ],
    }
    if extra:
        header["extra"] = extra
    arrays = {f"leaf_{i:04d}": a for i, a in enumerate(host)}
    arrays["header"] = np.frombuffer(
        json.dumps(header).encode("utf-8"), dtype=np.uint8)
    # A temp name of its own: two savers to one path must not truncate
    # each other's half-written zip.
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return len(host)


def read_header(path: str) -> Dict[str, Any]:
    raw = None
    try:
        with np.load(path) as z:
            if "header" in z.files:
                raw = bytes(z["header"])
    except Exception as e:  # a torn zip, a missing file, ... with the path
        raise ValueError(f"{path}: unreadable checkpoint ({e})") from e
    if raw is None:
        raise ValueError(f"{path}: no checkpoint header")
    try:
        header = json.loads(raw.decode("utf-8"))
    except Exception as e:
        raise ValueError(f"{path}: corrupt checkpoint header ({e})") from e
    if header.get("format") != FORMAT:
        raise ValueError(
            f"{path}: not a {FORMAT} checkpoint "
            f"(format={header.get('format')!r})"
        )
    return header


def _stored_dtype(arr: np.ndarray, header: Dict[str, Any], i: int) -> str:
    """A member's dtype name: raw 2-byte data the header calls bfloat16
    is bfloat16."""
    specs = header.get("leaves") or []
    named = specs[i].get("dtype") if i < len(specs) else None
    if named == BF16 and arr.dtype.itemsize == 2 and arr.dtype.kind in "Vu":
        return BF16
    return str(arr.dtype)


def _restore(arr: np.ndarray, dtype: str, tmpl):
    if not isinstance(tmpl, torch.Tensor):
        return int(arr)
    if dtype == BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return t.view(torch.bfloat16).to(tmpl.device)
    return torch.from_numpy(np.array(arr)).to(tmpl.device)


def load_stream_state(
    path: str,
    template: Any,
    *,
    benchmark: str = "",
) -> Tuple[Any, Dict[str, Any]]:
    """Restore a carry saved by :func:`save_stream_state` (or by the JAX
    package's) into the structure of ``template``, the carry a fresh
    ``stream_body()`` just returned. Every leaf must match the template
    in shape and dtype, and when both sides name a benchmark they must
    agree; otherwise ``ValueError`` names the leaf or the benchmark and
    nothing is restored. Returns ``(carry, header)``."""
    header = read_header(path)
    if benchmark and header.get("benchmark") and \
            header["benchmark"] != benchmark:
        raise ValueError(
            f"{path}: checkpoint is for benchmark "
            f"{header['benchmark']!r}, not {benchmark!r}"
        )
    flat = leaves(template)
    if header["n_leaves"] != len(flat):
        raise ValueError(
            f"{path}: checkpoint has {header['n_leaves']} leaves, "
            f"template has {len(flat)}"
        )
    checked: List[Tuple[np.ndarray, str]] = []
    with np.load(path) as z:
        for i, tmpl in enumerate(flat):
            key = f"leaf_{i:04d}"
            if key not in z.files:
                raise ValueError(f"{path}: missing array {key}")
            arr = z[key]
            got = _stored_dtype(arr, header, i)
            want_shape, want_dtype = _shape(tmpl), _dtype_name(tmpl)
            if arr.shape != want_shape or got != want_dtype:
                raise ValueError(
                    f"{path}: leaf {i} is {got}{list(arr.shape)}, "
                    f"template wants {want_dtype}{list(want_shape)}"
                )
            checked.append((arr, got))
    restored = [_restore(arr, got, tmpl)
                for (arr, got), tmpl in zip(checked, flat)]
    return rebuild(template, iter(restored)), header
