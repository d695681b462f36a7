"""The spread of a metric between runs, from their result lines.

    python3 portbench/spread.py SET_DIR [SET_DIR ...]

Each directory is one set of runs.  A run is a file ``<cell>@<seed>.out``
holding what the run printed on standard output (its last line is the
result); a file ``<cell>@<seed>.err`` beside it, where there is one, adds
each set-up stage the run printed on standard error as ``setup:<stage>``.
Prints a Markdown table: for each metric, cell and set the runs' median,
their quartile spread (``statistics.quantiles(n=4)``: the third quartile
less the first, over the median) and that spread with the run farthest
from the median left out; then, for each metric, the widest spread over
every set and cell with the bound that three times it gives, rounded up to
the next hundredth.  Imported by no reader.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import sys
from typing import Dict, List, Tuple

_STAGE = re.compile(r"^setup stage (.+): ([0-9.eE+-]+) s$")
RULE = 3  # the bound is this many times the widest spread


def quartile_spread(values: List[float]) -> float:
    """(third quartile - first quartile) / median."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def farthest_out(values: List[float]) -> List[float]:
    """The values without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def rule_bound(spread: float) -> float:
    """``RULE`` times ``spread``, rounded up to the next hundredth."""
    return math.ceil(round(RULE * spread * 100, 9)) / 100


def read_run(path: str) -> Tuple[dict, Dict[str, float]]:
    """(the result line, the set-up stages) of one run's output file."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    line = json.loads(lines[-1])
    stages = {}
    err = os.path.splitext(path)[0] + ".err"
    if os.path.isfile(err):
        with open(err) as f:
            for ln in f:
                m = _STAGE.match(ln.strip())
                if m:
                    stages[m.group(1)] = float(m.group(2))
    return line, stages


def read_set(directory: str) -> Dict[Tuple[str, str], List[float]]:
    """(metric, cell) -> the values of a set's runs, in order of seed."""
    out: Dict[Tuple[str, str], List[float]] = {}
    for name in sorted(os.listdir(directory)):
        if not (name.endswith(".out") and "@" in name):
            continue
        cell = name.rsplit("@", 1)[0]
        line, stages = read_run(os.path.join(directory, name))
        values = {k: v["value"] for k, v in line["metrics"].items()}
        values.update({"setup:" + k: v for k, v in stages.items()})
        values["correct"] = float(line["correct"])
        for k, v in values.items():
            out.setdefault((k, cell), []).append(float(v))
    return out


def table(sets: Dict[str, Dict[Tuple[str, str], List[float]]]) -> str:
    rows = ["| Metric | Cell | Set | Runs | Median | Spread | Farthest out |",
            "|---|---|---|---|---|---|---|"]
    widest: Dict[str, Tuple[float, str]] = {}
    keys = sorted({k for s in sets.values() for k in s})
    for metric, cell in keys:
        if metric == "correct":
            continue
        for name, runs in sets.items():
            values = runs.get((metric, cell))
            if not values:
                continue
            med = statistics.median(values)
            if len(values) < 3 or med == 0:
                rows.append(f"| `{metric}` | `{cell}` | {name} | "
                            f"{len(values)} | {med!r} | - | - |")
                continue
            sp = quartile_spread(values)
            far = (quartile_spread(farthest_out(values))
                   if len(values) >= 4 else float("nan"))
            rows.append(f"| `{metric}` | `{cell}` | {name} | {len(values)} "
                        f"| {med!r} | {100 * sp:.3f}% | {100 * far:.3f}% |")
            if sp >= widest.get(metric, (-1.0, ""))[0]:
                widest[metric] = (sp, f"{cell}, {name}")
    rows += ["", f"| Metric | Widest spread (where) | {RULE}x, rounded up |",
             "|---|---|---|"]
    for metric, (sp, where) in sorted(widest.items()):
        rows.append(f"| `{metric}` | {100 * sp:.3f}% ({where}) "
                    f"| {rule_bound(sp):.2f} |")
    for name, runs in sets.items():
        ok = [v for (m, _), vs in runs.items() if m == "correct" for v in vs]
        rows.append(f"\nSet {name}: {int(sum(ok))} of {len(ok)} runs correct.")
    return "\n".join(rows)


def main(argv: List[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sets = {os.path.basename(os.path.normpath(d)): read_set(d) for d in argv}
    print(table(sets))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
