"""Plain reference of the rndmem_65536 configuration.

Each voice t reads S contiguous samples of the pool from its playhead
p_b(t) in block b, into out[i, t] = pool[p_b(t) + i]. The playhead
starts at the voice's loop start and advances by S a block, back to the
start where it would reach the loop's end, so in closed form
p_b = start + S (b mod L), L = max(1, ceil((end - start) / S)). A
block's probe is the stream's mean |value|, the float32 L1 norm over the
element count, which this file computes as the program's probe
(``harness/streaming.py:probe``) is defined, so that a gathered block
that is bit for bit right gives the same float32 probe. It imports
nothing of the program. How a cell's outputs are judged against it is
``rndmem_65536.<kind>.py``.

``precision="bf16"`` is the control: the pool rounded to bfloat16
before the gather.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def make_inputs(conf, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The pool, uniform in [0, 1), and each voice's loop from ``seed``,
    drawn on ``device`` as the upstream draws them: starts over the pool
    short of one block, lengths min_loop + [0, max_loop - min_loop),
    ends clipped one short of the last start."""
    n = conf["pool_mib"] * 1024 * 1024 // 4
    t, s = conf["tracks"], conf["buffer_size"]
    last = n - s
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    pool = torch.rand(n, generator=g, device=device, dtype=torch.float32)
    starts = torch.randint(0, last, (t,), generator=g, device=device,
                           dtype=torch.int64)
    lens = conf["min_loop"] + torch.randint(
        0, conf["max_loop"] - conf["min_loop"], (t,), generator=g,
        device=device, dtype=torch.int64)
    ends = torch.minimum(starts + lens, torch.full_like(starts, last - 1))
    return {"pool": pool, "starts": starts, "ends": ends}


def playheads(inputs, conf, block: int, device) -> torch.Tensor:
    """Every voice's playhead in block ``block`` (0 = the first), int64."""
    s = conf["buffer_size"]
    start = torch.as_tensor(inputs["starts"]).to(device)
    end = torch.as_tensor(inputs["ends"]).to(device)
    span = torch.clamp(torch.div(end - start + s - 1, s, rounding_mode="floor"), min=1)
    return start + s * torch.remainder(torch.full_like(start, block), span)


def probe(y: torch.Tensor) -> float:
    norm = torch.linalg.vector_norm(y, 1, dtype=torch.float32)
    return float((norm / y.numel()).reshape(1)[0])


def block_probe(pool: torch.Tensor, inputs, conf, block: int, device) -> float:
    s = conf["buffer_size"]
    ph = playheads(inputs, conf, block, device)
    idx = ph[None, :] + torch.arange(s, device=device)[:, None]
    return probe(pool[idx])


def stream_outputs(inputs, conf, blocks: int, checked: Sequence[int], device,
                   precision: str = "f32") -> Dict:
    """The playheads after ``blocks`` blocks, and the probes of the
    ``checked`` blocks."""
    pool = torch.as_tensor(inputs["pool"]).to(device)
    if precision == "bf16":
        pool = pool.to(torch.bfloat16).to(torch.float32)
    probes = {b: block_probe(pool, inputs, conf, b, device) for b in checked}
    final = playheads(inputs, conf, blocks, device).cpu().numpy()
    return {"state": {"playheads": final}, "probes": probes}
