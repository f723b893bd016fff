"""Interactive benchmark runner UI (the WebGPU app analog) of the port.

PyTorch counterpart of ``gpuaudiobench_tpu/webui``: a local HTTP server
wrapping the same harness the port's CLI uses, plus a self-contained
single-file front end (no CDN: a GPU host may have no egress).

    python -m gpuaudiobench_tpu_torch.webui --port 8800 [--device cpu]

Package layout:
  params.py -- declarative parameter schemas (ParameterBuilder analog,
               webgpu/js/core/ParameterBuilder.js) mapped onto the
               port's BenchConfig fields.
  server.py -- stdlib ThreadingHTTPServer + JSON API + one worker
               thread that serializes device access.
  static/index.html -- the front end.
"""

from gpuaudiobench_tpu_torch.webui.params import (  # noqa: F401
    apply_params,
    benchmark_params,
    global_params,
)
