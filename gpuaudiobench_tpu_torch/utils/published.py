"""Published baselines: the DAFx-24 poster's tables for the web UI's
comparison column.

The port's copy of ``gpuaudiobench_tpu/utils/published.py``. The tables
live in the port's ``analysis/compare.py``.
"""

from __future__ import annotations

from typing import Any, Dict


def published_tables() -> Dict[str, Any]:
    from gpuaudiobench_tpu_torch.analysis import compare

    return {
        "published": compare.PUBLISHED,
        "notes": compare.NOTES,
        "modal_sweep": compare.MODAL_SWEEP,
    }
