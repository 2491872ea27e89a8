"""Compare training runs' learning curves side by side.

The counterpart of the JAX package's ``scripts/compare_runs.py``: given two
(or more) runs' ``save_dir``, print per generation the average loss and the
bucketed accuracy of one metric table (``8ply`` by default) of each run,
then each run's last row, so that configurations (K=1 against K=8, say)
can be compared on identical workloads. It reads the port's JSON tables
(``training.tables``), and prints what the JAX script prints from the same
rows in its pandas pickles.

    python -m connect4_tpu_torch.scripts.compare_runs NAME=DIR NAME=DIR [--table 8ply]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

COLUMNS = ("Average loss", "Accuracy")


def compare(runs, table: str = "8ply") -> list:
    """The printed lines for ``runs`` (``NAME=DIR`` or ``DIR``)."""
    from connect4_tpu_torch.training.tables import load_table, table_path

    tables = {}
    for spec in runs:
        name, _, path = spec.partition("=")
        if not path:
            name, path = os.path.basename(spec.rstrip("/")), spec
        if not os.path.exists(table_path(path, table)):
            print(f"{name}: no {table} table under {path}", file=sys.stderr)
            continue
        tables[name] = load_table(path, table)
    if not tables:
        raise SystemExit("nothing to compare")

    lines = ["gen  " + "  ".join(f"{name + '.' + c:>22}" for name in tables for c in COLUMNS)]
    for g in range(max(len(rows) for rows in tables.values())):
        row = [f"{g + 1:>3}  "]
        for rows in tables.values():
            for c in COLUMNS:
                if g < len(rows) and c in rows[g]:
                    row.append(f"{rows[g][c]:>22.5f}")
                else:
                    row.append(f"{'-':>22}")
        lines.append("  ".join(row))
    for name, rows in tables.items():
        if rows:
            last = rows[-1]
            lines.append("")
            lines.append(f"{name}: final gen {len(rows)}: " + ", ".join(
                f"{c}={v:.5f}" for c, v in last.items() if isinstance(v, float)))
    return lines


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("runs", nargs="+", metavar="NAME=DIR")
    parser.add_argument("--table", default="8ply", help="metric table: 8ply, 7ply or match_results")
    args = parser.parse_args(argv)
    lines = compare(args.runs, args.table)
    print("\n".join(lines))
    print(json.dumps({"runs": args.runs, "table": args.table, "lines": len(lines)}))
    return lines


if __name__ == "__main__":
    main()
