"""The spread of a cell's runs, as the bounds are set from it: for each
end-to-end metric, each set's median and the distance between its first
and third quartiles (Python's statistics.quantiles(values, n=4)) as a
share of the median.

    python3 -m benchmark.tools.spread <set A result files> -- <set B result files>

Each file holds a run's standard output; its last line is the result.
"""

from __future__ import annotations

import json
import statistics
import sys


def results(paths):
    out = []
    for p in paths:
        with open(p) as f:
            out.append(json.loads(f.read().strip().splitlines()[-1]))
    return out


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return statistics.median(values), (q3 - q1) / statistics.median(values)


def main(argv):
    cut = argv.index("--")
    sets = [results(argv[:cut]), results(argv[cut + 1:])]
    names = sorted(set().union(*(r["metrics"] for s in sets for r in s)))
    for name in names:
        row = [name]
        for s in sets:
            vals = [r["metrics"][name]["value"] for r in s if name in r["metrics"]]
            med, sp = spread(vals)
            row.append(f"median {med!r} spread {sp:.4%} of {len(vals)}: {vals}")
        print("\n  ".join(row))
    print("correct:", [[r["correct"] for r in s] for s in sets])


if __name__ == "__main__":
    main(sys.argv[1:])
