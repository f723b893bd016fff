"""One block of device work captured once as a CUDA graph and replayed.

A block made of many small launches (the LSTM's 512 dependent steps, a
handful of torch ops each) costs more host time to enqueue than the card
spends on it. ``CapturedBlock`` records such a block once with
``torch.cuda.CUDAGraph`` and replays the recording: one host call a
block, whatever its launch count.

A graph reads and writes fixed addresses. So the block is a function
over tensors the ``CapturedBlock`` owns (``static``): a call copies its
arguments into them (skipping one that already is its static tensor),
replays, and returns the tensors the function returned at capture. Every
replay writes those same output tensors again: a caller that keeps an
output across replays must copy it.

The function must not write its inputs, must not wait for the device
(no ``.item()``, no branch on a tensor's value) and must allocate the
same shapes on every call. A capture that breaks a rule raises; nothing
falls back to running the function eagerly. On the CPU there is no
graph, and the constructor raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

WARMUP_CALLS = 2


class CapturedBlock:
    """``fn(*static)`` captured as one CUDA graph. ``block(*args)`` copies
    ``args`` into ``static`` and replays; ``block()`` replays on the
    static inputs as they stand. Both return the captured outputs (a
    tuple). Each replay adds one to ``counts[key]`` when ``counts`` is
    given."""

    def __init__(self, fn: Callable[..., Tuple[torch.Tensor, ...]],
                 static: Sequence[torch.Tensor],
                 counts: Optional[Dict[str, int]] = None, key: str = ""):
        self.static = tuple(static)
        devices = {t.device for t in self.static}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(
                "CapturedBlock: the static tensors must lie on one CUDA "
                f"device, got {sorted(str(d) for d in devices)}")
        self.device = next(iter(devices))
        self.counts, self.key = counts, key
        # Warm up on a side stream (cuBLAS handles and workspaces, the
        # allocator's blocks), then capture on the stream torch.cuda.graph
        # provides. The function is pure, so warming up on the static
        # inputs leaves them as they were.
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                fn(*self.static)
        current.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                out = fn(*self.static)
        except RuntimeError as e:
            raise RuntimeError(
                f"CapturedBlock: capturing {key or 'the block'} failed: "
                f"{e}") from e
        self.outputs = tuple(out) if isinstance(out, (tuple, list)) else (out,)

    def __call__(self, *args: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if args:
            if len(args) != len(self.static):
                raise ValueError(f"CapturedBlock: {len(args)} arguments for "
                                 f"{len(self.static)} static inputs")
            for a, s in zip(args, self.static):
                if a.shape != s.shape:
                    raise ValueError(f"CapturedBlock: argument of shape "
                                     f"{tuple(a.shape)} for a static input "
                                     f"of {tuple(s.shape)}")
                if a.data_ptr() != s.data_ptr():
                    s.copy_(a)
        self.graph.replay()
        if self.counts is not None:
            self.counts[self.key] += 1
        return self.outputs
