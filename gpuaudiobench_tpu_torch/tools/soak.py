"""Sustained-load soak: continuous streaming for N seconds of audio.

PyTorch counterpart of the reference's ``tools/soak.py``. The saturated
tier measures steady-state cost over a few hundred blocks; this drives
a streaming workload continuously, one second of audio (ceil(fs/S)
blocks) a call with the state carried across every block, and records
the wall time of each second, deadline misses and drift over minutes,
plus two integrity signals outside the timed region:

* **probe RMS**: the RMS of the blocks' probes (mean |output| a block,
  ``harness.streaming.probe``). For DWG it is zero by construction: the
  reference's update confines energy to closed cell pairs and reads the
  output at a pair the injection never touches (``models/dwg.py``).
* **state RMS** (``stream_state_rms``): the RMS over the carry's float
  leaves that have moved off the entry carry, computed on the card (one
  scalar read). A leaf still bit-identical to its entry value (an input
  block, a sample pool, a mode table) is left out, so a large carried
  constant cannot dilute a diverging recurrence; if no leaf has moved,
  the whole carry's RMS is reported. The comparison needs a copy of the
  entry carry for the whole soak, because bodies write their carry in
  place; the report gives its size (both 262 MB rails of DWG1DNaive at
  32,768 waveguides).

A second of audio runs in one of two forms (``Seconds``), which the
report names (``chain form``):

* ``"cuda-graph"``: on a CUDA device, a capturable body runs as one
  continuing ``harness.graph.ChainGraph``: the graph reads the carry
  from its static tensors and its captured tail copies the exit carry
  back into them, so each replay starts where the last one ended (the
  reference's ``one_second`` scan, whose exit carry is the next call's
  entry carry).
* ``"loop"``: on the CPU, for a body its benchmark declares
  uncapturable (NeuralAmpLSTM), and for a carry whose Python values
  advance within a second by other than a whole period (PartConv's
  nupols phase, K blocks a period, over 94 blocks): a graph fixes those
  values as its capture saw them, so the graph's warm-up, an eager
  second on its own copy of the carry, raises ``AdvancingCarry`` before
  anything is captured, and the soak runs the loop instead.

Unlike the reference, whose warm-up call advances the state one
uncounted second, the soak's carry advances exactly ``seconds`` seconds,
so N seconds, or 1 second, a checkpoint and a resumed N - 1, end on the
same carry. The timed region of a second is one replay (or loop) plus
the probe read.

``reexcite_every=N`` adds 0.5x the entry carry to every float leaf that
has moved off it, every N seconds, in place (integer leaves and
unchanged constants are left alone): a fresh pluck, to confirm the state
responds to new energy mid-soak. ``--renorm`` sets ``modal_renorm``
(``config.py``), exclusive with re-excitation.

``--checkpoint PATH`` saves the carry every 30 soak seconds and at the
end (``harness/checkpoint.py``, .npz); with ``--resume`` the soak first
restores the carry from PATH.

Usage: python -m gpuaudiobench_tpu_torch.tools.soak [seconds] [output.md]
           [benchmark] [tracks] [reexcite_every] [--set FIELD=VALUE ...]
           [--checkpoint PATH] [--resume] [--renorm] [--device cuda|cpu]
       (defaults: 60 s, <temp dir>/soak.md, ModalFilterBank, 1024 tracks,
        0 = never re-excite, the card)
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gpuaudiobench_tpu_torch.harness.graph import (
    AdvancingCarry,
    ChainGraph,
    _tensors,
    clone_carry,
    leaves,
)

CHECKPOINT_EVERY = 30  # soak seconds between checkpoints


def _float_pairs(c, c0):
    return [(a, b) for a, b in zip(leaves(c), leaves(c0))
            if isinstance(a, torch.Tensor) and a.is_floating_point()]


def stream_state_rms(c, c0) -> torch.Tensor:
    """RMS over the carry's float leaves that differ from the entry
    carry ``c0``, as a 0-d float32 tensor on the carry's device; the whole
    float carry's RMS when none differs, 0 when it has no float leaf.
    Squares are taken in each leaf's dtype and summed in float32, as the
    reference does."""
    pairs = _float_pairs(c, c0)
    if not pairs:
        return torch.zeros((), dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=pairs[0][0].device)
    sq_all = n_all = sq_ev = n_ev = zero
    for a, b in pairs:
        sq = torch.sum(torch.square(a).float())
        n = torch.full((), float(a.numel()), dtype=torch.float32,
                       device=zero.device)
        evolved = (a != b).any()
        sq_all, n_all = sq_all + sq, n_all + n
        sq_ev = sq_ev + torch.where(evolved, sq, zero)
        n_ev = n_ev + torch.where(evolved, n, zero)
    return torch.where(n_ev > 0,
                       torch.sqrt(sq_ev / torch.clamp(n_ev, min=1.0)),
                       torch.sqrt(sq_all / n_all))


def reexcite(c, c0) -> None:
    """Add 0.5x the entry carry ``c0`` to every float leaf of ``c`` that
    differs from it, in place. A leaf equal to its entry value is a
    carried constant (or state that has not moved, for which the sum is
    the identity anyway) and is left alone, as integer leaves are."""
    for a, b in _float_pairs(c, c0):
        if not torch.equal(a, b):
            a.add_(b, alpha=0.5)


class Seconds:
    """``blocks`` steps of ``step_fn`` a call (one second of audio), the
    state carried from call to call, in the ``form`` the module's
    docstring sets out.

    On a CUDA device a capturable body's carry must be on the card; the
    continuing graph is built there, and ``advancing`` says whether its
    warm-up found the carry's Python values advancing (then the form is
    the loop; None where no graph was tried). ``run()`` returns the
    second's probes on the host; ``carry()`` is the state the next call
    starts from (the graph's static tensors, in the graph form, which
    ``reexcite`` may write in place)."""

    def __init__(self, step_fn: Callable, carry, blocks: int,
                 device: torch.device, capturable: bool = True,
                 name: str = ""):
        self._step, self._blocks = step_fn, blocks
        self._graph: Optional[ChainGraph] = None
        self._carry = carry
        self.advancing: Optional[bool] = None
        if device.type == "cuda" and capturable:
            try:
                self._graph = ChainGraph(step_fn, carry, blocks, name=name,
                                         continuing=True)
                self._carry, self.advancing = None, False
            except AdvancingCarry:
                self.advancing = True
        self.form = "cuda-graph" if self._graph is not None else "loop"

    def carry(self):
        return self._graph.carry() if self._graph is not None else self._carry

    def run(self) -> np.ndarray:
        if self._graph is not None:
            return self._graph.run().numpy()
        c, probes = self._carry, []
        for _ in range(self._blocks):
            c, p = self._step(c)
            probes.append(p)
        self._carry = c
        return torch.cat(probes).cpu().numpy()


def carry_bytes(carry) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(carry))


def run_soak(bench, seconds: int, *, reexcite_every: int = 0,
             checkpoint: str = "", resume: bool = False,
             log: Callable[[str], None] = print) -> Dict:
    """Soak a set-up benchmark's stream body for ``seconds`` seconds of
    audio. Returns ``rows`` ((second, wall ms, ms a block, probe RMS,
    state RMS) a second), ``form``, ``carry`` (the final state),
    ``blocks`` (a second), ``entry_bytes`` (the entry copy) and
    ``peak_bytes`` (the card's peak allocation, None on the CPU)."""
    from gpuaudiobench_tpu_torch.harness.checkpoint import (
        load_stream_state,
        save_stream_state,
    )

    name, cfg, device = bench.name, bench.cfg, bench.device
    body = bench.stream_body()
    if body is None:
        raise ValueError(f"{name} has no streaming mode; nothing to soak")
    step_fn, carry = body
    blocks = -(-cfg.fs // cfg.buffer_size)  # 94 at 48k/512
    deadline_ms = cfg.deadline_ms()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    carry0 = clone_carry(carry)  # the entry carry, for the state RMS
    if resume:
        carry, hdr = load_stream_state(checkpoint, carry, benchmark=name)
        log(f"resumed carry from {checkpoint} "
            f"(saved {hdr.get('saved_at')}, "
            f"{hdr.get('extra', {}).get('soak_seconds', '?')} soak s)")
    second = Seconds(step_fn, carry, blocks, device,
                     bench.stream_capturable, name)
    log(f"soaking {seconds}s of audio ({name}, {bench.track_count} tracks, "
        f"{blocks} blocks/s, chain form {second.form})...")
    rows = []
    for sec in range(seconds):
        if reexcite_every and sec and sec % reexcite_every == 0:
            reexcite(second.carry(), carry0)  # outside the timed region
        t0 = time.perf_counter()
        probes = second.run()  # waits for the card
        wall = (time.perf_counter() - t0) * 1000.0
        per_block = wall / blocks
        rms = float(np.sqrt(np.mean(probes.astype(np.float64) ** 2)))
        srms = float(stream_state_rms(second.carry(), carry0))
        rows.append((sec, wall, per_block, rms, srms))
        if checkpoint and (sec % CHECKPOINT_EVERY == CHECKPOINT_EVERY - 1
                           or sec == seconds - 1):
            save_stream_state(
                checkpoint, second.carry(), benchmark=name,
                extra={"soak_seconds": sec + 1,
                       "tracks": bench.track_count})
        if sec % 10 == 0 or per_block > deadline_ms:
            log(f"  t={sec:4d}s wall={wall:8.2f} ms "
                f"({per_block:.3f} ms/block) probe_rms={rms:.4g} "
                f"state_rms={srms:.4g}")
    return {
        "rows": rows,
        "form": second.form,
        "carry": second.carry(),
        "blocks": blocks,
        "entry_bytes": carry_bytes(carry0),
        "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda
        else None,
    }


def render(result: Dict, *, name: str, tracks: int, buffer_size: int,
           deadline_ms: float, card: str, reexcite_every: int = 0,
           renorm: bool = False) -> str:
    """The soak's markdown report: the reference's rows, with the card
    (its name and power limit) in the title, and the chain form, the
    entry copy and the peak device memory."""
    rows, blocks = result["rows"], result["blocks"]
    seconds = len(rows)
    per_block = np.array([r[2] for r in rows])
    rms = np.array([r[3] for r in rows])
    srms = np.array([r[4] for r in rows])
    misses = int((per_block > deadline_ms).sum())
    # Drift robust to one slow second at either end: the median of the
    # first W seconds against the last W.
    win = max(1, min(10, seconds // 4))
    drift_pct = (np.median(per_block[-win:])
                 / np.median(per_block[:win]) - 1) * 100
    form = result["form"]
    how = ("one CUDA graph replay" if form == "cuda-graph"
           else "one loop of launches")
    peak = result["peak_bytes"]
    lines = [
        f"# Sustained-load soak ({card}): {name} "
        f"({tracks} tracks), continuous",
        "",
        f"{seconds} seconds of audio processed block-by-block with "
        "carried state",
        f"({blocks} x {buffer_size}-sample blocks per second, {how} per "
        "second of audio,",
        "timed through a real D2H read). Generated by "
        "`python -m gpuaudiobench_tpu_torch.tools.soak`.",
        "",
        "| metric | value |",
        "|---|---:|",
        f"| seconds of audio | {seconds} |",
        f"| mean ms/block | {per_block.mean():.4f} |",
        f"| p50 / p95 / max ms/block (per-second averages) | "
        f"{np.percentile(per_block, 50):.4f} / "
        f"{np.percentile(per_block, 95):.4f} / {per_block.max():.4f} |",
        f"| seconds over the {deadline_ms:.3f} ms/block deadline | "
        f"{misses} |",
        f"| drift, median of first {win} s -> last {win} s | "
        f"{drift_pct:+.2f}% |",
        f"| probe RMS first / last (output liveness) | "
        f"{rms[0]:.4g} / {rms[-1]:.4g} |",
        f"| state RMS first / last (carry integrity) | "
        f"{srms[0]:.4g} / {srms[-1]:.4g} |",
        f"| state RMS min / max over the soak | "
        f"{srms.min():.4g} / {srms.max():.4g} |",
        f"| chain form | {form} |",
        f"| entry copy of the carry (state RMS, re-excitation) | "
        f"{result['entry_bytes'] / 2**20:.1f} MiB |",
        "| peak device memory | "
        + (f"{peak / 2**20:.1f} MiB |" if peak is not None
           else "not measured (CPU) |"),
    ]
    if reexcite_every:
        lines.append(
            f"| re-excitation (0.5x initial state into float leaves) | "
            f"every {reexcite_every} s |")
    if renorm:
        lines.append(
            "| phasor magnitude renorm (--modalRenorm) | every block |")
    if name.startswith("DWG") and rms.max() == 0.0:
        lines += [
            "",
            "Probe RMS 0 is STRUCTURAL for DWG, not a dead stream: the",
            "reference's update reads and writes the same cell pair per",
            "sample (bench_dwg.cu:372-390, writePos never advances), so",
            "the output-tap cells form a closed zero-energy system and",
            "the tap output is identically zero by construction (see",
            "models/dwg.py dwg_reference docstring; test-pinned).",
            "Liveness for DWG is the state-RMS row above.",
        ]
    return "\n".join(lines) + "\n"


def write_csv(rows: List, csv_path: str) -> None:
    with open(csv_path, "w") as f:
        f.write("second,wall_ms,ms_per_block,probe_rms,state_rms\n")
        for sec, wall, pb, r, sr in rows:
            f.write(f"{sec},{wall:.4f},{pb:.6f},{r:.6g},{sr:.6g}\n")


def _take_flag(argv: List[str], flag: str) -> bool:
    if flag in argv:
        argv.remove(flag)
        return True
    return False


def _take_value(argv: List[str], flag: str) -> Optional[str]:
    """The value after ``flag`` (removed with it); "" when it is missing;
    None when the flag is absent."""
    if flag not in argv:
        return None
    i = argv.index(flag)
    if i + 1 >= len(argv) or argv[i + 1].startswith("--"):
        return ""
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    resume = _take_flag(argv, "--resume")
    ckpt_path = _take_value(argv, "--checkpoint")
    if ckpt_path == "":
        print("--checkpoint requires a PATH argument")
        return 1
    renorm = _take_flag(argv, "--renorm")
    device = _take_value(argv, "--device") or device
    overrides = []
    while "--set" in argv:  # BenchConfig overrides, as the capacity tool
        value = _take_value(argv, "--set")
        if not value:
            print("--set requires a FIELD=VALUE argument")
            return 1
        overrides.append(value)
    if resume and not ckpt_path:
        print("--resume requires --checkpoint PATH")
        return 1
    seconds = int(argv[0]) if len(argv) > 0 else 60
    out_path = (argv[1] if len(argv) > 1
                else os.path.join(tempfile.gettempdir(), "soak.md"))
    name = argv[2] if len(argv) > 2 else "ModalFilterBank"
    tracks = int(argv[3]) if len(argv) > 3 else 1024
    reexcite_every = int(argv[4]) if len(argv) > 4 else 0
    if renorm and reexcite_every:
        # Renorm pins magnitudes to their initial values, so it would
        # cancel the re-excitation's injected amplitude one block later.
        print("--renorm and reexcite_every are mutually exclusive: "
              "renorm pins magnitudes to their INITIAL values and "
              "would erase the injected energy on the next block")
        return 1

    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.harness.base import Benchmark
    from gpuaudiobench_tpu_torch.registry import create_benchmark
    from gpuaudiobench_tpu_torch.tools.capacity import parse_overrides
    from gpuaudiobench_tpu_torch.utils import device as dv

    torch_dev = dv.device(device)
    cfg = BenchConfig(
        n_tracks=tracks,
        n_runs=1, warmup=1, write_latencies=False, device_timing=False,
        verification="none", modal_renorm=renorm,
        **parse_overrides(overrides),
    )
    bench = create_benchmark(name, cfg, torch_dev)
    if type(bench).stream_body is Benchmark.stream_body:
        print(f"{name} has no streaming mode; nothing to soak")
        return 1
    bench.setup()
    result = run_soak(bench, seconds, reexcite_every=reexcite_every,
                      checkpoint=ckpt_path or "", resume=resume)
    ident = dv.gpu_identity(torch_dev)
    card = (f"{ident['device_name']}, {ident['power_limit']}"
            if torch_dev.type == "cuda" else "cpu")
    text = render(result, name=name, tracks=tracks,
                  buffer_size=cfg.buffer_size,
                  deadline_ms=cfg.deadline_ms(), card=card,
                  reexcite_every=reexcite_every, renorm=renorm)
    with open(out_path, "w") as f:
        f.write(text)
    csv_path = os.path.splitext(out_path)[0] + ".csv"
    if csv_path == out_path:  # extensionless out_path
        csv_path = out_path + ".csv"
    write_csv(result["rows"], csv_path)
    print(f"written: {out_path} + {csv_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
