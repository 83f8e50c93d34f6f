"""Format a realism table into the paper's LaTeX row and the averaged views
(scripts/format_results.py), without pandas:

  python -m mobi_tpu_torch.format_results results/realism/realism_table.csv

Reads the `realism_table.csv` that `realism_test_bench` writes and prints
(a) the metric row in reference-mode order and (b) the reinsertion (id /
track) and replacement (in- / cross-domain) averages, as the JAX script
prints them through pandas: the first row of each reference type kept, the
metrics rounded as numpy rounds (`np.round`, half to even after scaling),
floats printed as float64's `str` (`79.0`, `nan`), the averages over the
deduplicated table skipping NaN (an empty field is NaN).
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np

from mobi_tpu_torch.data.table import Table, read_csv

ORDER = ["id-ref", "track-ref", "in-domain-ref", "cross-domain-ref"]
METRICS = ("FID", "LPIPS", "CLIP", "D-LPIPS", "I-LPIPS", "FRD")
ROUNDING = {"FID": 2, "LPIPS": 3, "CLIP": 2, "D-LPIPS": 3, "I-LPIPS": 3, "FRD": 2}


def _first_of_each(table: Table, key: str) -> Table:
    """drop_duplicates(subset=key): the first row of each value."""
    seen, keep = set(), []
    for i, v in enumerate(table[key]):
        if v not in seen:
            seen.add(v)
            keep.append(i)
    return table.take(keep)


def _row_values(table: Table, cols: List[str]) -> List:
    """`DataFrame[cols].round(ROUNDING).values.reshape(-1)`, row by row: the
    rounded float columns; numeric columns share one dtype (int64 only
    when every one is int), other columns keep each value's own type."""
    rounded = {c: np.round(table[c], ROUNDING[c]) if table[c].dtype.kind == "f" else table[c] for c in cols}
    if all(rounded[c].dtype.kind in "if" for c in cols) and any(rounded[c].dtype.kind == "f" for c in cols):
        rounded = {c: v.astype(np.float64) for c, v in rounded.items()}
    return [rounded[c][i] for i in range(len(table)) for c in cols]


def _mean_skipna(values: np.ndarray) -> float:
    """pandas' nanmean: the sum of the non-NaN values over their count."""
    values = values.astype(np.float64)
    live = ~np.isnan(values)
    count = int(live.sum())
    return float(np.where(live, values, 0.0).sum() / count) if count else float("nan")


def _average(table: Table, modes, cols: List[str]) -> Optional[Dict[str, float]]:
    sel = table[np.isin(table["Reference Type"], modes)]
    if not len(sel):
        return None
    return {c: float(np.round(_mean_skipna(sel[c]), 3)) for c in cols}


def main(path: str) -> None:
    df = _first_of_each(read_csv(path, index_col=None), "Reference Type")
    present = [m for m in ORDER if m in set(df["Reference Type"])]
    df_sorted = df.take([list(df["Reference Type"]).index(m) for m in present])
    metric_cols = [c for c in METRICS if c in df_sorted.columns]
    row = " & ".join(str(v) for v in _row_values(df_sorted, metric_cols))
    print("latex row:", row)

    re_avg = _average(df, ["id-ref", "track-ref"], metric_cols)
    rep_avg = _average(df, ["in-domain-ref", "cross-domain-ref"], metric_cols)
    if re_avg is not None:
        print("reinsertion avg:", re_avg)
    if rep_avg is not None:
        print("replacement avg:", rep_avg)


if __name__ == "__main__":
    main(sys.argv[1])
