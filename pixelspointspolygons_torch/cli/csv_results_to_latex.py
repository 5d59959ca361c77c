"""Metric CSVs (the ablations' and the entry points') to a paper table —
twin of scripts/csv_results_to_latex.py, through
`Evaluator.to_latex_table`.

Usage: python -m pixelspointspolygons_torch.cli.csv_results_to_latex results1.csv [results2.csv ...] \
    [type=modality|density|resolution|all] [caption=...] [label=...] [out=table.tex]

Host code only: it reads CSVs and runs on any machine.
"""

from __future__ import annotations

import logging
import sys

from ..eval.evaluator import Evaluator
from ._common import print_line


def main(argv: list[str] | None = None) -> str | None:
    import pandas as pd

    argv = list(sys.argv[1:] if argv is None else argv)
    paths = [a for a in argv if a.endswith(".csv")]
    kv = dict(a.split("=", 1) for a in argv if "=" in a and not a.endswith(".csv"))
    if not paths:
        print_line("usage: csv_results_to_latex.py <csv> [...] [type=modality] [out=table.tex]")
        return None
    df = pd.concat([pd.read_csv(p) for p in paths], ignore_index=True)
    ev = Evaluator.__new__(Evaluator)
    ev.logger = logging.getLogger("csv_results_to_latex")
    tex = ev.to_latex_table(
        df,
        table_type=kv.get("type", "modality"),
        caption=kv.get("caption", "Results"),
        label=kv.get("label", "tab:results"),
        outfile=kv.get("out"),
    )
    print_line(tex)
    return tex


if __name__ == "__main__":
    main()
