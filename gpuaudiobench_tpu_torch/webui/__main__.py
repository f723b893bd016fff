"""`python -m gpuaudiobench_tpu_torch.webui` entry point."""

from gpuaudiobench_tpu_torch.webui.server import main

if __name__ == "__main__":
    raise SystemExit(main())
