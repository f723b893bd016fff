"""Published-baselines loader.

The port's copy of ``gpuaudiobench_tpu/utils/published.py``. The DAFx-24
poster numbers live in the repo-level ``analysis/compare.py`` (tooling,
not part of either package); the web UI's comparison column needs its
PUBLISHED/NOTES/MODAL_SWEEP tables, so this loads that file by path.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Any, Dict, Optional


def load_compare_module() -> Optional[Any]:
    """analysis/compare.py as a module, or None outside a repo checkout."""
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        "analysis", "compare.py",
    )
    try:
        spec = importlib.util.spec_from_file_location("gpuab_compare", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)  # type: ignore[union-attr]
        return mod
    except (OSError, AttributeError, ImportError, FileNotFoundError):
        return None


def published_tables() -> Dict[str, Any]:
    mod = load_compare_module()
    if mod is None:
        return {"published": {}, "notes": {}, "modal_sweep": {}}
    return {
        "published": mod.PUBLISHED,
        "notes": mod.NOTES,
        "modal_sweep": mod.MODAL_SWEEP,
    }
