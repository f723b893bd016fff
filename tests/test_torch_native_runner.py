"""The port's native runner (``gpuaudiobench_tpu_torch/csrc/native_runner.cc``,
built by ``utils/native.py:build_runner``) on the CPU: it links libtorch
and no libpython, checks its argv, runs the ``gain`` package with no
interpreter in the process and prints the checksum the JAX runner's mock
test asserts (``tests/test_pjrt_runner.py``), and refuses the ``modal``
package, whose kernel operator has no CPU implementation outside Python:
there is no fallback to the twin. The card's run is ``chip_smoke.py``'s."""

import dataclasses
import importlib.util
import os
import re
import subprocess

import pytest

from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.ops import gpuab
from gpuaudiobench_tpu_torch.tools import export_programs as ep
from gpuaudiobench_tpu_torch.utils import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def runner():
    return str(native.build_runner())


@pytest.fixture(scope="module")
def ops_lib():
    gpuab.load()
    return gpuab.library_path()


@pytest.fixture(scope="module")
def packages(tmp_path_factory, ops_lib):
    """``gain`` at the defaults (the JAX mock test's program) and ``modal``
    at 4 tracks x 64 samples, exported for the CPU."""
    out = tmp_path_factory.mktemp("packages")
    ep.export("gain", str(out), "cpu")
    small = dataclasses.replace(BenchConfig(), n_tracks=4, buffer_size=64)
    ep.export("modal", str(out), "cpu", small)
    return out


def _run(runner, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([runner, *args], capture_output=True, text=True,
                          timeout=120, env=env, cwd="/")


def _package(packages, name, ops_lib, *extra):
    return ["--package", str(packages / f"{name}.pt2"), "--spec",
            str(packages / f"{name}.spec"), "--ops", ops_lib, *extra]


def test_runner_builds_from_the_packages_source(runner):
    assert os.path.isfile(runner) and os.access(runner, os.X_OK)
    assert runner == str(native.runner_path())
    assert native.runner_path().parent == native.BUILD_DIR
    assert os.path.basename(runner).startswith("native_runner-")
    assert native.RUNNER_SOURCE.name == "native_runner.cc"
    compile_flags, link = native.torch_flags(native.with_cuda())
    assert "-std=c++20" in compile_flags
    # PyTorch's headers and libraries live in site-packages; no libpython.
    assert not any(flag.startswith("-lpython") or "libpython" in flag
                   or "torch_python" in flag for flag in link)
    assert str(native.build_runner()) == runner  # the keyed binary, reused


def test_runner_links_no_python(runner):
    libs = subprocess.run(["ldd", runner], capture_output=True, text=True,
                          check=True).stdout
    names = [line.split()[0] for line in libs.splitlines() if line.strip()]
    assert any(n.startswith("libtorch.so") for n in names), libs
    assert any(n.startswith("libc10.so") for n in names), libs
    assert not [n for n in names if "python" in n], libs


def test_runner_prints_usage_without_arguments(runner):
    r = _run(runner)
    assert r.returncode == 1 and "usage: native_runner" in r.stderr


@pytest.mark.parametrize("args,message", [
    (["--bogus"], "unknown flag --bogus"),
    (["--runs"], "--runs requires a value"),
    (["--package", "p.pt2", "--spec", "p.spec", "--device", "tpu"],
     "--device takes cuda or cpu"),
    (["--package", "p.pt2", "--spec", "p.spec", "--device", "cpu", "--ops",
      "/nonexistent.so"], "dlopen failed"),
])
def test_runner_rejects_bad_arguments(runner, args, message):
    r = _run(runner, *args)
    assert r.returncode == 1 and message in r.stderr, r.stderr


def test_runner_defaults_to_the_card(runner, packages, ops_lib):
    """Only a caller that names the CPU gets it; this build has no CUDA."""
    r = _run(runner, *_package(packages, "gain", ops_lib))
    assert r.returncode == 1
    assert "built without CUDA: only --device cpu runs here" in r.stderr


def _lcg_checksum():
    spec = importlib.util.spec_from_file_location(
        "test_pjrt_runner_checksum", os.path.join(ROOT, "tests",
                                                  "test_pjrt_runner.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._lcg_checksum()


def test_gain_package_runs_natively_on_the_cpu(runner, packages, ops_lib):
    r = _run(runner, *_package(packages, "gain", ops_lib, "--runs", "5",
                               "--device", "cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout
    assert "devices: 1 addressable (cpu)" in out
    assert re.search(r"load: [0-9.]+ ms", out)
    assert "inputs: 1 uploaded, outputs: 1" in out
    assert re.search(r"runs: 5  p50: [0-9.]+ ms  p95: [0-9.]+ ms", out)
    m = re.search(r"checksum (-?\d+\.\d+)", out)
    assert m, out
    # The JAX runner's mock test's assertion: 2x the LCG's first 64 draws.
    assert abs(float(m.group(1)) - _lcg_checksum()) < 1e-3
    module, spec = ep.make_program("gain", "cpu")
    want = ep.checksum(ep.first_output(module(*ep.lcg_inputs(spec))))
    assert float(m.group(1)) == pytest.approx(want, abs=1e-5)


def test_modal_package_has_no_cpu_kernel_outside_python(runner, packages,
                                                        ops_lib):
    """The operator library defines the schemas; the CPU twin is a Python
    registration, absent here, so the runner exits naming the missing
    kernel instead of falling back."""
    r = _run(runner, *_package(packages, "modal", ops_lib, "--runs", "2",
                               "--device", "cpu"))
    assert r.returncode == 1
    assert ("Could not run 'gpuab::modal_bank_launch' with arguments from "
            "the 'CPU' backend") in r.stderr, r.stderr[-2000:]
    assert "checksum" not in r.stdout


def test_a_missing_package_exits_1(runner, tmp_path, ops_lib):
    spec = tmp_path / "p.spec"
    spec.write_text("f32 4 4\n")
    r = _run(runner, "--package", str(tmp_path / "none.pt2"), "--spec",
             str(spec), "--ops", ops_lib, "--device", "cpu")
    assert r.returncode == 1 and r.stderr.startswith("native_runner: ")
