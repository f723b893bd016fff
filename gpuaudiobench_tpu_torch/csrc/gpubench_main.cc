// gpubench-torch: native command-line driver of the PyTorch / CUDA port.
//
// The reference's entry point is native (cuda/main.cu). This executable
// owns the process surface (argv validation, exit codes) and drives the
// port through an embedded CPython: it imports
// gpuaudiobench_tpu_torch.cli and calls main(args), which runs on the
// card. Flags are validated here and forwarded verbatim, so
// `gpubench-torch ...` and `python -m gpuaudiobench_tpu_torch.cli ...`
// are interchangeable. A flag the port has not ported
// (cli.UNPORTED_FLAGS) is not in the tables: it warns here and the
// Python side refuses it.
//
// CPython is initialised through PyConfig with program_name set to the
// interpreter that built this binary (GPUBENCH_PYTHON), so the
// interpreter's own prefix (a virtual environment's too) and its
// site-packages, torch among them, are found. GPUBENCH_ROOT, the
// directory holding the package that built it, goes first on sys.path.
//
// Build: python -m gpuaudiobench_tpu_torch.utils.native
//   (utils/native.py:build_driver: g++ with python3-config --includes and
//   --ldflags --embed of that interpreter's installation).

#include <Python.h>

#include <cstdio>
#include <cstring>

#ifndef GPUBENCH_PYTHON
#error "define GPUBENCH_PYTHON, the interpreter's path (utils/native.py)"
#endif
#ifndef GPUBENCH_ROOT
#error "define GPUBENCH_ROOT, the package's parent directory"
#endif

namespace {

// The port's CLI surface (gpuaudiobench_tpu_torch/cli.py: VALUE_FLAGS
// plus --benchmarkFilter; SWITCHES plus --help and --list), without
// UNPORTED_FLAGS. tests/test_torch_native_driver.py holds these tables
// to the Python source.
const char* kValueFlags[] = {
    "--benchmark",       "--category",          "--fs",
    "--bufferSize",      "--nTracks",           "--nRuns",
    "--warmup",          "--outputfile",        "--verification",
    "--dawsim-mode",     "--dawsim-jitter-us",  "--impl",
    "--iirForm",         "--iirBlockM",         "--modalModes",
    "--irLength",        "--convEdgeMode",      "--partconvForm",
    "--partconvTailChunk", "--partconvHDtype",  "--sessionEqStages",
    "--neuralampChannels", "--neuralampLayers", "--neuralampDtype",
    "--csvSchema",       "--latenciesFile",     "--captureDir",
    "--poolMiB",         "--transferMiB",       "--dwgMinLen",
    "--dwgMaxLen",       "--fdtdRoom",          "--solFmaK",
    "--solFmaMiB",       "--solVmemMiB",        "--solStreamMiB",
    "--solMatmulDim",    "--pipelineDepth",     "--saturatedReps",
    "--overlapDepth",    "--overlapReps",       "--seed",
    "--mesh",            "--dataParallel",      "--benchmarkFilter",
};

const char* kBoolFlags[] = {
    "--help",    "--list",           "--json",
    "--quiet",   "--dawsim",         "--capture",
    "--no-device-timing",            "--noSaturatedMarginal",
    "--modalRenorm",                 "--fdtdPerTrackReceivers",
};

bool InTable(const char* arg, const char* const* table, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    if (std::strcmp(arg, table[i]) == 0) return true;
  }
  return false;
}

bool IsValueFlag(const char* arg) {
  return InTable(arg, kValueFlags, sizeof(kValueFlags) / sizeof(*kValueFlags));
}

bool IsBoolFlag(const char* arg) {
  return InTable(arg, kBoolFlags, sizeof(kBoolFlags) / sizeof(*kBoolFlags));
}

// Py_InitializeFromConfig with program_name = GPUBENCH_PYTHON and no
// argument parsing of its own. Returns false (and prints why) on failure.
bool InitPython() {
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.parse_argv = 0;
  PyStatus status =
      PyConfig_SetBytesString(&config, &config.program_name, GPUBENCH_PYTHON);
  if (!PyStatus_Exception(status)) status = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(status)) {
    std::fprintf(stderr, "gpubench-torch: CPython did not start (%s%s%s)\n",
                 status.func ? status.func : "",
                 status.func ? ": " : "", status.err_msg ? status.err_msg : "");
    return false;
  }
  PyObject* path = PySys_GetObject("path");  // borrowed
  PyObject* root = PyUnicode_FromString(GPUBENCH_ROOT);
  bool ok = path != nullptr && root != nullptr &&
            PyList_Insert(path, 0, root) == 0;
  Py_XDECREF(root);
  if (!ok) PyErr_Print();
  return ok;
}

}  // namespace

int main(int argc, char** argv) {
  std::printf("GPU Audio Benchmark, PyTorch / CUDA port (native driver)\n");
  std::fflush(stdout);  // keep the order with the interpreter's stdout

  // Unknown flags warn (cuda/main.cu:302); a value flag without its value
  // fails before the interpreter starts.
  for (int i = 1; i < argc; ++i) {
    if (IsValueFlag(argv[i])) {
      if (i + 1 >= argc) {
        std::printf("Error: %s requires an argument\n", argv[i]);
        return 1;
      }
      ++i;
    } else if (!IsBoolFlag(argv[i])) {
      std::printf("Warning: Unparsed argument: %s\n", argv[i]);
    }
  }
  std::fflush(stdout);

  if (!InitPython()) return 1;

  int exit_code = 1;
  PyObject* mod = PyImport_ImportModule("gpuaudiobench_tpu_torch.cli");
  if (mod == nullptr) {
    PyErr_Print();
    std::fprintf(stderr, "gpubench-torch: could not import "
                         "gpuaudiobench_tpu_torch.cli\n");
  } else {
    PyObject* fn = PyObject_GetAttrString(mod, "main");
    PyObject* args = PyList_New(0);
    for (int i = 1; fn != nullptr && args != nullptr && i < argc; ++i) {
      PyObject* s = PyUnicode_DecodeFSDefault(argv[i]);
      if (s == nullptr || PyList_Append(args, s) != 0) {
        Py_XDECREF(s);
        Py_CLEAR(args);
        break;
      }
      Py_DECREF(s);
    }
    PyObject* result = (fn != nullptr && args != nullptr)
        ? PyObject_CallFunctionObjArgs(fn, args, nullptr)
        : nullptr;
    if (result == nullptr) {
      PyErr_Print();  // a SystemExit exits here with its own code
    } else {
      long rc = PyLong_AsLong(result);
      if (rc == -1 && PyErr_Occurred()) {
        PyErr_Print();
      } else {
        exit_code = static_cast<int>(rc);
      }
      Py_DECREF(result);
    }
    Py_XDECREF(args);
    Py_XDECREF(fn);
    Py_DECREF(mod);
  }

  std::fflush(stdout);
  if (Py_FinalizeEx() < 0) return 120;
  return exit_code;
}
