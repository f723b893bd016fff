"""The port's native driver (``csrc/gpubench_main.cc``, built by
``utils/native.py:build_driver`` with g++ and the interpreter's
``python3-config``): its argv checks before the interpreter starts, its
flag tables against the port's CLI surface, ``--list`` through the
embedded interpreter, the port's refusals, and no CPU fallback on a
machine without a card. Also: the package's copy of the harness core's
C++ source is the repo-level file byte for byte, and the pacer builds
from the copy."""

import inspect
import os
import re
import subprocess
import sys

import pytest
import torch

from gpuaudiobench_tpu_torch import cli
from gpuaudiobench_tpu_torch.registry import list_benchmarks
from gpuaudiobench_tpu_torch.utils import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNER = "GPU Audio Benchmark, PyTorch / CUDA port (native driver)"


@pytest.fixture(scope="module")
def driver():
    return str(native.build_driver())


def _run(driver, *args, timeout=120):
    # Another directory, and no PYTHONPATH: the driver finds the package
    # that built it and the interpreter's own site-packages.
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([driver, *args], capture_output=True, text=True,
                          timeout=timeout, cwd="/", env=env)


def test_driver_builds_from_the_packages_source(driver):
    assert os.path.isfile(driver) and os.access(driver, os.X_OK)
    path = native.driver_path()
    assert str(path) == driver
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("gpubench-")
    assert native.DRIVER_SOURCE == (
        native.PACKAGE_ROOT / "gpuaudiobench_tpu_torch" / "csrc"
        / "gpubench_main.cc")
    # The interpreter that built it is compiled in.
    compile_flags, link = native.driver_flags()
    assert f'-DGPUBENCH_PYTHON="{sys.executable}"' in compile_flags
    assert any(f.startswith("-lpython") for f in link)
    # A second call reuses the keyed binary.
    assert str(native.build_driver()) == driver


def test_driver_list_prints_the_registry(driver):
    r = _run(driver, "--list")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == BANNER
    assert lines[1] == "Available benchmarks:"
    assert lines[2:] == list_benchmarks()
    assert len(lines[2:]) == 30


def test_missing_value_fails_before_the_interpreter(driver):
    r = _run(driver, "--benchmark")
    assert r.returncode == 1
    assert r.stdout.splitlines() == [
        BANNER, "Error: --benchmark requires an argument"]


def test_unknown_flag_warns_and_the_cli_refuses_it(driver):
    r = _run(driver, "--bogusFlag", "--list")
    assert "Warning: Unparsed argument: --bogusFlag" in r.stdout
    assert "Error: unknown argument: --bogusFlag (see --help)" in r.stdout
    assert r.returncode == 1


def test_unported_flag_exits_with_the_not_ported_message(driver):
    r = _run(driver, "--compilationCacheDir", "x")
    assert r.returncode == 1
    assert "Warning: Unparsed argument: --compilationCacheDir" in r.stdout
    assert ("Error: --compilationCacheDir is not ported to the PyTorch CLI "
            "yet; see ROADMAP.md 'Not ported' (XLA only)") in r.stdout


def test_flag_tables_are_the_ports_cli_surface():
    """The driver's tables hold the port's parse_args surface minus
    UNPORTED_FLAGS, each derived from the source (as
    tests/test_native.py does for the JAX driver)."""
    text = (native.DRIVER_SOURCE).read_text()

    def flags_in(table):
        m = re.search(table + r"\[\] = \{(.*?)\};", text, re.S)
        return set(re.findall(r'"(--[\w-]+)"', m.group(1)))

    cli_src = inspect.getsource(cli)
    value_block = re.search(r"VALUE_FLAGS = \{(.*?)\n\}", cli_src, re.S)
    switch_block = re.search(r"SWITCHES = \{(.*?)\n\}", cli_src, re.S)
    py_value = set(re.findall(r'"(--[\w-]+)": \(', value_block.group(1)))
    py_src = inspect.getsource(cli.parse_args)
    compared = set(re.findall(r'arg == "(--[\w-]+)"', py_src))
    py_value |= {"--benchmarkFilter"} & compared
    py_bool = (set(re.findall(r'"(--[\w-]+)": \(', switch_block.group(1)))
               | compared) - py_value
    assert py_value == set(cli.VALUE_FLAGS) | {"--benchmarkFilter"}
    assert py_bool == set(cli.SWITCHES) | {"--help", "--list"}
    assert flags_in("kValueFlags") == py_value - set(cli.UNPORTED_FLAGS)
    assert flags_in("kBoolFlags") == py_bool - set(cli.UNPORTED_FLAGS)
    assert not (flags_in("kValueFlags") | flags_in("kBoolFlags")) & set(
        cli.UNPORTED_FLAGS)


@pytest.mark.skipif(torch.cuda.is_available(), reason="this machine has a "
                    "card: the run would go to it")
def test_driver_runs_on_the_card_and_never_falls_back_to_the_cpu(driver):
    r = _run(driver, "--benchmark", "gain", "--nRuns", "2")
    assert r.returncode == 1
    assert ("RuntimeError: CUDA requested but torch.cuda.is_available() is "
            "False") in r.stderr
    assert "Done" not in r.stdout
    assert "Device:" not in r.stdout


def test_driver_source_names_no_module_of_the_jax_package():
    text = native.DRIVER_SOURCE.read_text()
    assert 'PyImport_ImportModule("gpuaudiobench_tpu_torch.cli")' in text
    assert not re.search(r"gpuaudiobench_tpu\.", text)
    assert not re.search(r"\bjax", text, re.IGNORECASE)


def test_native_core_source_is_the_repo_files_copy():
    with open(os.path.join(ROOT, "native", "gpuab_native.cc"), "rb") as f:
        original = f.read()
    assert native.SOURCE == native.PACKAGE_ROOT / "gpuaudiobench_tpu_torch" \
        / "csrc" / "gpuab_native.cc"
    assert native.SOURCE.read_bytes() == original


def test_pacer_library_builds_from_the_packages_copy():
    lib = native.build()
    assert lib == native.library_path()
    assert lib.is_file()
    stats = native.calculate_statistics_native([1.0, 2.0, 3.0])
    assert stats.median == 2.0 and stats.count == 3


def test_a_failed_driver_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "gpubench_main.cc"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "DRIVER_SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_driver()
    assert not list((tmp_path / "build").glob("gpubench-*"))


def test_pyproject_names_the_ports_entry_points():
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        text = f.read()
    assert 'gpubench-torch = "gpuaudiobench_tpu_torch.cli:main"' in text
    assert ('gpubench-torch-ui = "gpuaudiobench_tpu_torch.webui.server:main"'
            in text)
    assert '"csrc/*.cc"' in text
