"""Declarative parameter schemas for the interactive UI.

PyTorch counterpart of ``gpuaudiobench_tpu/webui/params.py`` (the
ParameterBuilder analog, webgpu/js/core/ParameterBuilder.js:1-138): each
control is a JSON-able dict the front end renders generically (slider /
select / switch / number), and every control maps onto a real
``BenchConfig`` field of the port (``config.py``), so the UI surface and
the CLI surface stay one config system. ``apply_params`` is the single
params-dict -> BenchConfig funnel, shared by /api/run and the tests.

Every slider, select, default and mapping is the reference's, except
the impl labels, and the descriptions that named the TPU's parts (XLA,
VMEM, the MXU, the profiler's device tier), which name the card's. The
device mesh (``mesh``, MultiChipSuite and ICIBandwidth) and
``dataParallel`` are taken, and more than one rank runs as the CLI runs
it (``parallel/launch.py:spmd``).
"""

from __future__ import annotations

from typing import Any, Dict, List

from gpuaudiobench_tpu_torch.config import BenchConfig

def slider(
    pid: str,
    label: str,
    lo: float,
    hi: float,
    default: Any,
    step: float = 1,
    unit: str = "",
    description: str = "",
) -> Dict[str, Any]:
    return {
        "id": pid,
        "type": "slider",
        "label": label,
        "min": lo,
        "max": hi,
        "default": default,
        "step": step,
        "unit": unit,
        "description": description,
    }


def select(
    pid: str,
    label: str,
    default: Any,
    options: List[Dict[str, Any]],
    description: str = "",
) -> Dict[str, Any]:
    return {
        "id": pid,
        "type": "select",
        "label": label,
        "default": default,
        "options": options,
        "description": description,
    }


def switch(pid: str, label: str, default: bool, description: str = "") -> Dict[str, Any]:
    return {
        "id": pid,
        "type": "switch",
        "label": label,
        "default": default,
        "description": description,
    }


def _opts(values) -> List[Dict[str, Any]]:
    return [{"value": v, "label": str(v)} for v in values]


def global_params() -> List[Dict[str, Any]]:
    """Suite-wide controls (webgpu/index.html:100-150: buffer-size,
    track-count, iterations, warmup), extended with the harness knobs
    (verification mode, pipeline depth, impl)."""
    d = BenchConfig()
    return [
        select(
            "bufferSize",
            "Buffer Size",
            d.buffer_size,
            _opts([32, 64, 128, 256, 512, 1024, 2048]),
            "Samples per block; sets the real-time deadline "
            "(1000*bufferSize/fs ms)",
        ),
        slider(
            "nTracks", "Track Count", 1, 4096, d.n_tracks, 1, "tracks",
            "Parallel audio tracks per block",
        ),
        slider(
            "nRuns", "Iterations", 1, 1000, d.n_runs, 1, "",
            "Timed iterations per benchmark",
        ),
        slider(
            "warmup", "Warmup Iterations", 0, 20, d.warmup, 1, "",
            "Untimed iterations (absorb the kernels' build and first load)",
        ),
        select(
            "verification",
            "Verification",
            d.verification,
            [
                {"value": "full", "label": "Full"},
                {"value": "spot", "label": "Spot"},
                {"value": "none", "label": "None"},
            ],
            "Output validation against the CPU golden",
        ),
        slider(
            "pipelineDepth", "Pipeline Depth", 0, 2048, 0, 1, "blocks",
            "Saturated pass: blocks chained per executable "
            "(0 = round-trip timing only)",
        ),
        slider(
            "saturatedReps", "Saturated Reps", 5, 201, d.saturated_reps, 2,
            "reps",
            "Saturated-tier repetitions (>=101 gives a true p99)",
        ),
        slider(
            "overlapDepth", "Overlap Depth", 0, 512, 0, 1, "blocks",
            "Overlapped-infeed pass: upload block k+1 while block k "
            "computes, vs the serial twin (0 = off)",
        ),
        select(
            "impl",
            "Kernel Implementation",
            d.impl,
            [
                {"value": "auto",
                 "label": "Auto (hand-written CUDA kernel on the GPU)"},
                {"value": "pallas", "label": "Hand-written CUDA kernel"},
                {"value": "xla", "label": "Plain PyTorch twin (CPU only)"},
            ],
            "Device compute path selection",
        ),
        switch(
            "dawsim", "DAW-Load Simulation", d.dawsim,
            "Pace iterations to the buffer deadline (spin wait)",
        ),
        switch(
            "deviceTiming", "Device Timing Pass", d.device_timing,
            "CUDA-event on-device execution times",
        ),
    ]


# Per-benchmark parameter forms. Keyed by registry name; suffix-matched
# for the datacopy family.
def benchmark_params(name: str) -> List[Dict[str, Any]]:
    d = BenchConfig()
    if name.startswith("datacopy"):
        return [
            select(
                "transferMiB", "Transfer Pool", d.transfer_mib,
                _opts([10, 100, 1024]),
                "Base pool size in MiB (the poster's 10 MiB / 100 MiB / "
                "1 GiB variants)",
            ),
        ]
    if name == "IIRFilter":
        return [
            select(
                "iirForm", "Recurrence Form", d.iir_form,
                [
                    {"value": "scan", "label":
                     "scan (per-sample recurrence, reference form)"},
                    {"value": "blockstate", "label":
                     "blockstate (m samples per step, chain S/m)"},
                ],
                "Same filter; blockstate trades FLOPs for a shorter "
                "sequential chain",
            ),
            select(
                "iirBlockM", "Blockstate m", d.iir_block_m,
                [{"value": 0, "label": "auto (128 CUDA kernel / 16 plain twin)"}]
                + _opts([16, 32, 64, 128]),
                "Samples advanced per step (blockstate form only; "
                "clamped to a bufferSize divisor)",
            ),
        ]
    if name == "Conv1D":
        return [
            slider(
                "irLength", "Impulse Response Length", 64, 4096, 1024, 64,
                "samples", "Convolution IR length "
                "(webgpu ParameterBuilder.convolutionParams)",
            ),
            select(
                "convEdgeMode", "Edge Mode", d.conv_edge_mode,
                [
                    {"value": "clamp", "label": "Clamp (Metal/accel)"},
                    {"value": "bleed", "label": "Bleed (CUDA quirk)"},
                ],
                "Block-edge handling for the direct convolution",
            ),
        ]
    if name == "Conv1D_accel":
        return [
            slider(
                "irLength", "Impulse Response Length", 64, 4096, 512, 64,
                "samples", "FFT-convolution IR length",
            ),
        ]
    if name == "ModalFilterBank":
        return [
            slider(
                "modalModes", "Number of Modes", 0, 1048576, 0, 128, "",
                "Resonant modes in the bank; 0 = auto "
                "(min(1024*nTracks, 1M), ModalFilterBankBenchmark.swift:20)",
            ),
            switch(
                "modalRenorm", "Renormalize phasors (streaming)", False,
                "Pin each mode's magnitude to its initial value every "
                "block; off = reference parity (its f32 rotation drifts "
                "x185 over 1 h of audio)",
            ),
        ]
    if name == "RndMemRead":
        return [
            select(
                "poolMiB", "Sample Memory Pool", d.rndmem_pool_mb,
                _opts([128, 256, 512]),
                "HBM-resident grain pool (bench_rndmem.cuh: 512 MiB)",
            ),
            slider(
                "minLoop", "Min Loop Length", 100, 5000, d.rndmem_min_loop,
                100, "samples", "Minimum grain loop length",
            ),
            slider(
                "maxLoop", "Max Loop Length", 1000, 96000, d.rndmem_max_loop,
                1000, "samples", "Maximum grain loop length",
            ),
        ]
    if name == "FDTD3D":
        return [
            slider(
                "fdtdRoom", "Room Size", 10, 100, d.fdtd_room, 2,
                "cells/axis",
                "Room cells per axis (grid = room + 2 ghost cells; "
                "WebGPU ParameterBuilder.js fdtdParams 10-100); "
                "source/receiver scale at the reference fractions",
            ),
            switch(
                "fdtdPerTrackReceivers", "Per-Track Receivers",
                d.fdtd_per_track_receivers,
                "Each track reads its own receiver cell (WebGPU "
                "FDTD3DBenchmark.js:57-67) vs one broadcast receiver",
            ),
        ]
    if name.startswith("DWG1D"):
        return [
            slider(
                "dwgMinLen", "Min Waveguide Length", 16, 2000,
                d.dwg_min_length, 1, "samples",
                "Delay-line length distribution lower bound "
                "(CUDA 100; Metal used 64)",
            ),
            slider(
                "dwgMaxLen", "Max Waveguide Length", 64, 8000,
                d.dwg_max_length, 1, "samples",
                "Delay-line length distribution upper bound "
                "(CUDA 2000; Metal used 1024)",
            ),
        ]
    if name == "SOL_VPU":
        return [
            slider(
                "solFmaK", "FMA Passes", 8, 4096, d.sol_fma_k, 8, "",
                "Chained FMA passes per element (arithmetic intensity)",
            ),
            slider(
                "solFmaMiB", "Working Set", 1, 64, d.sol_fma_mib, 1, "MiB",
                "f32 array size, gridded through shared memory",
            ),
        ]
    if name == "SOL_VMEM":
        return [
            slider(
                "solFmaK", "FMA Passes", 8, 4096, d.sol_fma_k, 8, "",
                "Shared-memory round trips per element (one per pass)",
            ),
            slider(
                "solVmemMiB", "Block Size", 1, 16, d.sol_vmem_mib, 1, "MiB",
                "Loop-carried block (must exceed registers, fit shared memory)",
            ),
        ]
    if name == "SOL_HBM":
        return [
            select(
                "solStreamMiB", "Stream Size", d.sol_stream_mib,
                _opts([16, 64, 256]),
                "Array MiB per read+write pass (must dwarf the 50 MB L2)",
            ),
        ]
    if name.startswith("SOL_MXU"):
        return [
            select(
                "solMatmulDim", "Matmul Dimension", d.sol_matmul_dim,
                _opts([1024, 2048, 4096]),
                "Square matmul size (d^3 MACs)",
            ),
        ]
    if name == "PartConv":
        return [
            slider(
                "irLength", "Impulse Response Length", 512, 192000, 48000,
                512, "samples",
                "Reverb IR taps; partitions = ceil(irLength/bufferSize)",
            ),
            select(
                "partconvForm", "FDL Form", d.partconv_form,
                [
                    {"value": "shift", "label":
                     "shift (sequential rewrite; measured fastest)"},
                    {"value": "ring", "label":
                     "ring (one-slot write + H2 window)"},
                    {"value": "nupols", "label":
                     "nupols (two-level Gardner, long-IR scheme)"},
                ],
                "Frequency-domain delay line update strategy",
            ),
            select(
                "partconvTailChunk", "nupols Tail Chunk (blocks)",
                d.partconv_tail_chunk, _opts([4, 8, 16, 32]),
                "Tail partition size in blocks (nupols form only)",
            ),
            select(
                "partconvHDtype", "IR-Spectra Dtype", d.partconv_h_dtype,
                [
                    {"value": "f32", "label": "f32 (reference)"},
                    {"value": "f16", "label": "f16 (half the H read)"},
                ],
                "Storage precision of the partition spectra "
                "(measured 1.9e-4 peak-relative at f16)",
            ),
        ]
    if name == "DAWSessionMix":
        return [
            slider(
                "sessionEqStages", "EQ Stages per Track", 1, 16,
                d.session_eq_stages, 1, "",
                "Per-track biquad-cascade depth (staggered cutoffs)",
            ),
            slider(
                "irLength", "Reverb IR Length", 512, 192000, 48000,
                512, "samples",
                "Send-bus reverb tail; partitions = "
                "ceil(irLength/bufferSize)",
            ),
        ]
    if name in ("NeuralAmp", "NeuralAmpLSTM"):
        out = [
            select(
                "neuralampChannels",
                "Channels" if name == "NeuralAmp" else "Hidden Units",
                d.neuralamp_channels,
                _opts([32, 64, 128, 256]),
                "TCN channel width"
                if name == "NeuralAmp" else "LSTM hidden-state width",
            ),
            select(
                "neuralampDtype", "GEMM Dtype", d.neuralamp_dtype,
                [
                    {"value": "f32", "label": "f32 (HIGHEST precision)"},
                    {"value": "bf16", "label": "bf16 (tensor cores)"},
                ] + ([{"value": "int8",
                       "label": "int8 (tensor-core integer path)"}]
                     if name == "NeuralAmp" else []),
                "Contraction dtype; bf16/int8 validate against their "
                "own measured NN-inference contracts",
            ),
        ]
        if name == "NeuralAmp":
            out.insert(1, slider(
                "neuralampLayers", "Dilated Layers", 1, 12,
                d.neuralamp_layers, 1, "",
                "Network depth; receptive field = 2*(2^L - 1) + 1 samples",
            ))
        return out
    if name in ("MultiChipSuite", "ICIBandwidth"):
        return [
            select(
                "mesh", "Device Mesh (dp,tp,sp)", d.mesh,
                _opts(["1,1,1", "2,1,1", "2,2,1", "2,2,2", "4,2,1", "8,1,1"]),
                "Mesh axis sizes; product must not exceed visible devices",
            ),
        ]
    return []


# param id -> (BenchConfig field, type)
_FIELD_MAP = {
    "bufferSize": ("buffer_size", int),
    "nTracks": ("n_tracks", int),
    "nRuns": ("n_runs", int),
    "warmup": ("warmup", int),
    "verification": ("verification", str),
    "pipelineDepth": ("pipeline_depth", int),
    "saturatedReps": ("saturated_reps", int),
    "overlapDepth": ("overlap_depth", int),
    "impl": ("impl", str),
    "dawsim": ("dawsim", bool),
    "deviceTiming": ("device_timing", bool),
    "transferMiB": ("transfer_mib", int),
    "irLength": ("ir_length", int),
    "convEdgeMode": ("conv_edge_mode", str),
    "partconvForm": ("partconv_form", str),
    "partconvTailChunk": ("partconv_tail_chunk", int),
    "partconvHDtype": ("partconv_h_dtype", str),
    "neuralampChannels": ("neuralamp_channels", int),
    "neuralampLayers": ("neuralamp_layers", int),
    "neuralampDtype": ("neuralamp_dtype", str),
    "sessionEqStages": ("session_eq_stages", int),
    "iirForm": ("iir_form", str),
    "iirBlockM": ("iir_block_m", int),
    "modalModes": ("modal_num_modes", int),
    "modalRenorm": ("modal_renorm", bool),
    "dwgMinLen": ("dwg_min_length", int),
    "dwgMaxLen": ("dwg_max_length", int),
    "poolMiB": ("rndmem_pool_mb", int),
    "minLoop": ("rndmem_min_loop", int),
    "maxLoop": ("rndmem_max_loop", int),
    "fdtdPerTrackReceivers": ("fdtd_per_track_receivers", bool),
    "fdtdRoom": ("fdtd_room", int),
    "solFmaK": ("sol_fma_k", int),
    "solVmemMiB": ("sol_vmem_mib", int),
    "solFmaMiB": ("sol_fma_mib", int),
    "solStreamMiB": ("sol_stream_mib", int),
    "solMatmulDim": ("sol_matmul_dim", int),
    "seed": ("seed", int),
    "fs": ("fs", int),
    "mesh": ("mesh", str),
    "dataParallel": ("data_parallel", int),
}


def apply_params(cfg: BenchConfig, params: Dict[str, Any]) -> BenchConfig:
    """Fold a UI params dict into a BenchConfig; raises ValueError on
    unknown ids or values the config rejects."""
    updates: Dict[str, Any] = {}
    for pid, raw in (params or {}).items():
        if pid not in _FIELD_MAP:
            raise ValueError(f"unknown parameter: {pid}")
        field, typ = _FIELD_MAP[pid]
        try:
            val = typ(raw) if not (typ is bool and isinstance(raw, str)) else (
                raw.lower() in ("1", "true", "on", "yes")
            )
        except (TypeError, ValueError):
            raise ValueError(f"invalid value for {pid}: {raw!r}")
        # UI convention: modalModes 0 = auto (config wants None).
        if pid == "modalModes" and val == 0:
            val = None
        updates[field] = val
    cfg = cfg.replace(**updates)
    cfg.validate()
    return cfg
