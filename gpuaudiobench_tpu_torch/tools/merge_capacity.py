"""Merge capacity-search JSON records into one markdown table.

PyTorch port's copy of the reference's ``tools/merge_capacity.py`` (pure
JSON): several capacity runs (two buffer sizes, several benchmarks) each
write their own JSON; archiving wants one table. Records with different
deadlines (buffer sizes) are grouped into separate tables in one
document, each rendered by the port's ``capacity.render_md`` (with its
flag column).

Usage: python -m gpuaudiobench_tpu_torch.tools.merge_capacity out.md in1.json [in2.json ...]
"""

from __future__ import annotations

import json
import sys

from gpuaudiobench_tpu_torch.tools.capacity import render_md


def load_records(paths):
    records = []
    for path in paths:
        try:
            with open(path) as f:
                data = json.load(f)
        except OSError as e:
            # A missing family must not sink the whole ledger; say so
            # and merge the rest.
            print(f"WARNING: skipping {path}: {e}")
            continue
        records.extend(data if isinstance(data, list) else [data])
    return records


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print(__doc__.strip().splitlines()[-1])
        return 2
    out, paths = argv[0], argv[1:]
    records = load_records(paths)
    # Group by (buffer_size, fs): render_md states one deadline per table.
    groups: dict = {}
    for r in records:
        groups.setdefault((r["buffer_size"], r["fs"]), []).append(r)
    sections = [render_md(groups[key]) for key in sorted(groups)]
    with open(out, "w") as f:
        f.write("\n".join(sections))
    print(f"written: {out} ({len(records)} records, "
          f"{len(groups)} deadline group(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
