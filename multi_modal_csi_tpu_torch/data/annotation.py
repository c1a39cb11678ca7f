"""Annotation loading and filtering, without pandas: the port's copy of the
JAX package's ``data/annotation.py``.

The JAX package reads ``annotation.csv`` with ``pd.read_csv(dtype=str)``,
which keeps every cell a string except the missing ones, which become NaN
and print as ``"nan"`` once the label encoders call ``.astype(str)``. Here
the file is read with the ``csv`` module into an ``Annotation``: one numpy
string array per column, with every cell that pandas reads as missing
(an empty cell, ``NA``, ``NaN``, ``null`` ...) stored as ``"nan"``, so the
encoders' ``!= "nan"`` test and the encoding tables' ``"nan"`` rows work
as they do in JAX. Filters compare strings, as the reference does
(reference ``wifi_csi/load_data.py:15-44``).
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional, Sequence

import numpy as np

USER_LOCATION_COLS = [f"user_{i}_location" for i in range(1, 7)]
USER_ACTIVITY_COLS = [f"user_{i}_activity" for i in range(1, 7)]

# the strings pandas' read_csv takes for a missing value by default
PANDAS_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


class Annotation:
    """Rows of ``annotation.csv``: ``columns`` maps each column name to a
    numpy string array with one entry per row."""

    def __init__(self, columns: Dict[str, np.ndarray]):
        self.columns = columns

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()), ()))

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def take(self, rows: np.ndarray) -> "Annotation":
        """The rows selected by a boolean mask or an index array."""
        return Annotation({k: v[rows] for k, v in self.columns.items()})

    def matrix(self, names: Sequence[str]) -> np.ndarray:
        """(rows, len(names)) string array of the named columns."""
        return np.stack([self.columns[n] for n in names], axis=1)


def load_annotation(path: str) -> Annotation:
    """Read annotation.csv with every cell a string and missing cells as
    ``"nan"``."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [row + [""] * (len(header) - len(row)) for row in reader
                if row]
    columns = {}
    for i, name in enumerate(header):
        cells = ["nan" if row[i] in PANDAS_NA else row[i] for row in rows]
        columns[name] = np.array(cells, dtype=str)
    return Annotation(columns)


def filter_annotation(df: Annotation,
                      environment: Optional[Sequence[str]] = None,
                      wifi_band: Optional[Sequence[str]] = None,
                      num_users: Optional[Sequence[str]] = None
                      ) -> Annotation:
    """Rows whose environment, wifi_band and number_of_users are among the
    given strings; ``None`` disables that filter. Row order is kept."""
    keep = np.ones(len(df), dtype=bool)
    for column, values in (("environment", environment),
                           ("wifi_band", wifi_band),
                           ("number_of_users", num_users)):
        if values is not None:
            keep &= np.isin(df[column], np.asarray(list(values), dtype=str))
    return df.take(keep)


def label_list(df: Annotation) -> List[str]:
    return df["label"].tolist()
