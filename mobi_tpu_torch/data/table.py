"""A small columnar table: what the nuScenes dataset asks of pandas.

The port does not depend on pandas. `Table` keeps numpy columns and index labels,
and does what `data/nuscenes.py` calls and no more: column access, boolean
row masks, `loc`/`iloc`, `groupby` over sorted keys (iteration, `head`,
`sample`), `sample`, `sort_values`, `reset_index`, `iterrows`, `concat` and
`read_csv`. Rows come out as dicts of numpy scalars (strings as str).
Sampling draws as pandas 3.0 does: `np.random.RandomState(seed).choice(n,
size, replace)`, one RandomState shared by the groups of a grouped sample.
"""
from __future__ import annotations

import csv
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

RandomState = Union[int, np.random.RandomState]


def _random_state(seed: RandomState) -> np.random.RandomState:
    return seed if isinstance(seed, np.random.RandomState) else np.random.RandomState(seed)


class Table:
    def __init__(self, columns: Dict[str, np.ndarray], index: Optional[np.ndarray] = None):
        self._cols = {k: np.asarray(v) for k, v in columns.items()}
        n = len(next(iter(self._cols.values()))) if self._cols else 0
        self.index = np.arange(n) if index is None else np.asarray(index)

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, key):
        """A column by name, or the rows where a boolean mask is true."""
        if isinstance(key, str):
            return self._cols[key]
        return self.take(np.flatnonzero(np.asarray(key, bool)))

    def __setitem__(self, name: str, values) -> None:
        self._cols[name] = np.broadcast_to(np.asarray(values), (len(self),)).copy()

    def take(self, positions) -> "Table":
        positions = np.asarray(positions, np.int64)
        return Table({k: v[positions] for k, v in self._cols.items()}, self.index[positions])

    def iloc(self, i: int) -> Dict:
        return {k: v[i] for k, v in self._cols.items()}

    def loc(self, label) -> Dict:
        """The row with this index label (the first, where labels repeat)."""
        hits = np.flatnonzero(self.index == label)
        if not len(hits):
            raise KeyError(label)
        return self.iloc(int(hits[0]))

    def iterrows(self) -> Iterator[Tuple[object, Dict]]:
        for i, label in enumerate(self.index):
            yield label, self.iloc(i)

    def reset_index(self, drop: bool = True) -> "Table":
        if not drop:
            raise NotImplementedError("reset_index keeps no index column")
        return Table(self._cols)

    def sample(self, n: int, replace: bool = False, random_state: RandomState = None) -> "Table":
        return self.take(_random_state(random_state).choice(len(self), size=n, replace=replace))

    def sort_values(self, col: str, ascending: bool = True) -> "Table":
        """pandas' nargsort with its default quicksort."""
        values, idx = self._cols[col], np.arange(len(self))
        if not ascending:
            values, idx = values[::-1], idx[::-1]
        order = idx[values.argsort(kind="quicksort")]
        return self.take(order if ascending else order[::-1])

    def groupby(self, col: str) -> "GroupBy":
        return GroupBy(self, col)


class GroupBy:
    """Groups of a table by one column's value, keys sorted, rows of a group
    in table order."""

    def __init__(self, table: Table, col: str):
        self.table = table
        keys = table[col]
        self.groups = [(k, np.flatnonzero(keys == k)) for k in sorted(set(keys.tolist()))]

    def __iter__(self) -> Iterator[Tuple[object, Table]]:
        for key, positions in self.groups:
            yield key, self.table.take(positions)

    def head(self, n: int) -> Table:
        return self.table.take(np.sort(np.concatenate([np.zeros(0, np.int64)] + [p[:n] for _, p in self.groups])))

    def sample(self, n: int, replace: bool = False, random_state: RandomState = None) -> Table:
        rs = _random_state(random_state)
        picks = [p[rs.choice(len(p), size=n, replace=replace)] for _, p in self.groups]
        return self.table.take(np.concatenate([np.zeros(0, np.int64)] + picks))


def concat(tables: Sequence[Table], ignore_index: bool = False) -> Table:
    cols = {k: np.concatenate([t[k] for t in tables]) for k in tables[0].columns}
    return Table(cols, None if ignore_index else np.concatenate([t.index for t in tables]))


def _parse_column(cells: List[str]) -> np.ndarray:
    """pandas' type inference for one column: int64, then float64 (an empty
    cell is NaN), then bool for True/False, else str."""
    try:
        return np.array([int(c) for c in cells], np.int64)
    except ValueError:
        pass
    try:
        return np.array([float(c) if c != "" else np.nan for c in cells], np.float64)
    except ValueError:
        pass
    if set(cells) <= {"True", "False"}:
        return np.array([c == "True" for c in cells], bool)
    return np.array(cells, object)


def read_csv(path: str, index_col: Optional[int] = 0) -> Table:
    """A CSV with a header row -> Table, column `index_col` as the index."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    cols = {name: _parse_column([r[j] for r in body]) for j, name in enumerate(header)}
    if index_col is None:
        return Table(cols)
    name = header[index_col]
    index = cols.pop(name)
    return Table(cols, index)


def _cell(v) -> str:
    if isinstance(v, (float, np.floating)):
        return "" if np.isnan(v) else repr(float(v))
    return str(v)


def write_csv(path: str, columns: Sequence[str], rows: Sequence[Tuple[object, Dict]]) -> None:
    """pandas' `DataFrame.to_csv(path)` layout: a header of "" and the
    column names, then each row's index label and cells; a missing cell is
    empty, floats as repr."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + list(columns))
        for label, row in rows:
            w.writerow([_cell(label)] + [_cell(row[c]) if c in row else "" for c in columns])
