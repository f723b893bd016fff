"""Benchmark registry: the reference's names -> factories.

PyTorch counterpart of ``gpuaudiobench_tpu/registry.py`` (registration
order of cuda/main.cu:84-100). Only the ported benchmarks have a
factory; every other name raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.base import Benchmark

BENCHMARK_NAMES: List[str] = [
    "NoOp", "gain", "GainStats",
    "datacopy0199", "datacopy2080", "datacopy5050", "datacopy8020",
    "datacopy9901",
    "FFT1D", "IIRFilter", "Conv1D", "Conv1D_accel", "ModalFilterBank",
    "DWG1DNaive", "DWG1DAccel", "FDTD3D", "RndMemRead",
]

EXTENSION_NAMES: List[str] = [
    "BiquadChain", "PartConv", "NeuralAmp", "NeuralAmpLSTM",
    "DAWSessionMix", "MultiChipSuite", "ICIBandwidth",
    "SOL_VPU", "SOL_VMEM", "SOL_HBM",
    "SOL_MXU_bf16", "SOL_MXU_f32", "SOL_MXU_int8",
]


def _factories() -> Dict[str, Callable[[BenchConfig, torch.device], Benchmark]]:
    from gpuaudiobench_tpu_torch.models.modal import ModalFilterBankBenchmark

    return {"ModalFilterBank": ModalFilterBankBenchmark}


def create_benchmark(name: str, cfg: BenchConfig,
                     device: torch.device) -> Benchmark:
    factories = _factories()
    if name in factories:
        return factories[name](cfg, device)
    if name in BENCHMARK_NAMES or name in EXTENSION_NAMES:
        raise NotImplementedError(
            f"{name}: not yet ported; see ROADMAP.md")
    raise KeyError(f"Unknown benchmark: {name}")


def list_benchmarks() -> List[str]:
    return list(BENCHMARK_NAMES) + list(EXTENSION_NAMES)
