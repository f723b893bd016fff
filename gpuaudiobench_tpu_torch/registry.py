"""Benchmark registry: the reference's names -> factories.

PyTorch counterpart of ``gpuaudiobench_tpu/registry.py`` (registration
order of cuda/main.cu:84-100), with its suite categories. Only the
ported benchmarks have a factory; every other name raises
``NotImplementedError`` naming the ROADMAP.md item that ports it
(``UNPORTED_BENCHMARKS``). The descriptions are the reference's, for
``--help``.
"""

from __future__ import annotations

import functools
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

# Suite categories (the WebGPU UI's groups, webgpu/js/app.js:46-79, and
# the reference's extensions).
CATEGORIES = {
    "transfer": ["datacopy0199", "datacopy2080", "datacopy5050",
                 "datacopy8020", "datacopy9901"],
    "basic": ["NoOp", "gain", "GainStats"],
    "dsp": ["IIRFilter", "Conv1D", "Conv1D_accel", "ModalFilterBank",
            "FFT1D", "BiquadChain", "PartConv"],
    "physical": ["DWG1DNaive", "DWG1DAccel", "FDTD3D"],
    "memory": ["RndMemRead"],
    "neural": ["NeuralAmp", "NeuralAmpLSTM"],
    "session": ["DAWSessionMix"],
    "multichip": ["MultiChipSuite", "ICIBandwidth"],
    "speedoflight": ["SOL_VPU", "SOL_VMEM", "SOL_HBM",
                     "SOL_MXU_bf16", "SOL_MXU_f32", "SOL_MXU_int8"],
}

# The names without a factory here, with the ROADMAP.md item that ports
# them.
UNPORTED_BENCHMARKS = {
    "MultiChipSuite": "queue 1, item 18",
    "ICIBandwidth": "queue 1, item 18",
}


BENCHMARK_DESCRIPTIONS = {
    "NoOp": "No-operation baseline (dispatch overhead)",
    "gain": "Simple gain/volume control",
    "GainStats": "Gain with statistical analysis",
    "datacopy0199": "1% input, 99% output transfer",
    "datacopy2080": "20% input, 80% output transfer",
    "datacopy5050": "50% input, 50% output transfer",
    "datacopy8020": "80% input, 20% output transfer",
    "datacopy9901": "99% input, 1% output transfer",
    "FFT1D": "1D Fast Fourier Transform",
    "IIRFilter": "Infinite Impulse Response filter",
    "Conv1D": "1D convolution",
    "Conv1D_accel": "Accelerated 1D convolution",
    "ModalFilterBank": "Modal synthesis filter bank",
    "DWG1DNaive": "1D Digital Waveguide (naive)",
    "DWG1DAccel": "1D Digital Waveguide (accelerated)",
    "FDTD3D": "3D Finite Difference Time Domain",
    "RndMemRead": "Random memory access pattern",
    "BiquadChain": "Serial 10-stage biquad cascade (extension)",
    "PartConv": "Partitioned streaming convolution reverb (extension)",
    "NeuralAmp": "Streaming neural amp-model (TCN) inference on the MXU "
                 "(extension)",
    "NeuralAmpLSTM": "Streaming LSTM amp-model inference (per-sample "
                     "recurrence; extension)",
    "DAWSessionMix": "Full mixing-session graph: per-track EQ cascade -> "
                     "reverb send bus -> stereo mixdown (extension)",
    "MultiChipSuite": "Sharded dp/tp/sp/pp pipeline over --mesh (extension)",
    "ICIBandwidth": "Interconnect ring ppermute + psum (extension)",
    "SOL_VPU": "Speed-of-light: VPU f32 FMA throughput (measured peak)",
    "SOL_VMEM": "Speed-of-light: VMEM round-trip pass rate (measured peak)",
    "SOL_HBM": "Speed-of-light: HBM stream bandwidth (measured peak)",
    "SOL_MXU_bf16": "Speed-of-light: MXU bf16 matmul (measured peak)",
    "SOL_MXU_f32": "Speed-of-light: delivered f32 matmul (measured peak)",
    "SOL_MXU_int8": "Speed-of-light: MXU s8xs8->s32 matmul (measured peak)",
}


def _factories() -> Dict[str, Callable[[BenchConfig, torch.device], Benchmark]]:
    from gpuaudiobench_tpu_torch.models.biquad_chain import BiquadChainBenchmark
    from gpuaudiobench_tpu_torch.models.conv1d import Conv1DBenchmark
    from gpuaudiobench_tpu_torch.models.conv1d_accel import Conv1DAccelBenchmark
    from gpuaudiobench_tpu_torch.models.datatransfer import (
        DATACOPY_CONFIGS,
        DataTransferBenchmark,
    )
    from gpuaudiobench_tpu_torch.models.dwg import DWGBenchmark
    from gpuaudiobench_tpu_torch.models.fdtd3d import FDTD3DBenchmark
    from gpuaudiobench_tpu_torch.models.fft import FFTBenchmark
    from gpuaudiobench_tpu_torch.models.gain import GainBenchmark
    from gpuaudiobench_tpu_torch.models.gainstats import GainStatsBenchmark
    from gpuaudiobench_tpu_torch.models.iir import IIRBenchmark
    from gpuaudiobench_tpu_torch.models.modal import ModalFilterBankBenchmark
    from gpuaudiobench_tpu_torch.models.neuralamp import NeuralAmpBenchmark
    from gpuaudiobench_tpu_torch.models.noop import NoOpBenchmark
    from gpuaudiobench_tpu_torch.models.partconv import PartConvBenchmark
    from gpuaudiobench_tpu_torch.models.rndmem import RndMemBenchmark
    from gpuaudiobench_tpu_torch.models.session import DAWSessionMixBenchmark
    from gpuaudiobench_tpu_torch.models.speedoflight import (
        SolHbmStreamBenchmark,
        SolMxuBenchmark,
        SolVmemBenchmark,
        SolVpuFmaBenchmark,
    )

    return {
        "NoOp": NoOpBenchmark,
        "gain": GainBenchmark,
        "GainStats": GainStatsBenchmark,
        **{name: functools.partial(DataTransferBenchmark, name=name)
           for name in DATACOPY_CONFIGS},
        "FFT1D": FFTBenchmark,
        "IIRFilter": IIRBenchmark,
        "Conv1D": Conv1DBenchmark,
        "Conv1D_accel": Conv1DAccelBenchmark,
        "ModalFilterBank": ModalFilterBankBenchmark,
        "DWG1DNaive": DWGBenchmark,
        "DWG1DAccel": functools.partial(DWGBenchmark, accelerated=True),
        "FDTD3D": FDTD3DBenchmark,
        "RndMemRead": RndMemBenchmark,
        "BiquadChain": BiquadChainBenchmark,
        "PartConv": PartConvBenchmark,
        "NeuralAmp": NeuralAmpBenchmark,
        "NeuralAmpLSTM": functools.partial(NeuralAmpBenchmark, arch="lstm"),
        "DAWSessionMix": DAWSessionMixBenchmark,
        "SOL_VPU": SolVpuFmaBenchmark,
        "SOL_VMEM": SolVmemBenchmark,
        "SOL_HBM": SolHbmStreamBenchmark,
        "SOL_MXU_bf16": functools.partial(SolMxuBenchmark, dtype="bf16"),
        "SOL_MXU_f32": functools.partial(SolMxuBenchmark, dtype="f32"),
        "SOL_MXU_int8": functools.partial(SolMxuBenchmark, dtype="int8"),
    }


def ported_benchmarks() -> List[str]:
    """The names with a factory here, in registry order."""
    return [n for n in list_benchmarks() if n in _factories()]


def create_benchmark(name: str, cfg: BenchConfig,
                     device: torch.device) -> Benchmark:
    factories = _factories()
    if name in factories:
        return factories[name](cfg, device)
    if name in UNPORTED_BENCHMARKS:
        raise NotImplementedError(
            f"{name}: not yet ported; see ROADMAP.md "
            f"{UNPORTED_BENCHMARKS[name]}")
    raise KeyError(f"Unknown benchmark: {name}")


def list_benchmarks() -> List[str]:
    return list(BENCHMARK_NAMES) + list(EXTENSION_NAMES)
