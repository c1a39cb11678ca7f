"""Label encoders and set-target reduction: the port's copy of the JAX
package's ``data/encoders.py``, reading an ``Annotation`` instead of a
pandas frame.

- ``encode_identity``, ``encode_activity``, ``encode_location`` (reference
  ``wifi_csi/load_data.py:111-183``): per-user presence bits or one-hots,
  absent users (``"nan"``) encoded as all-zero rows;
- ``reduce_dataset`` (reference ``wifi_csi/utils.py:272-287``), bit-exact:
  the (6, C) per-user one-hots become (Q, C+1) set-prediction targets by
  deleting the FIRST all-zero row, appending a zero "no-person" column,
  turning every remaining all-zero row into the no-person one-hot, and
  optionally padding to ``num_object_queries`` rows of no-person.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.config import ACTIVITY_ENCODING, LOCATION_ENCODING
from .annotation import USER_ACTIVITY_COLS, USER_LOCATION_COLS, Annotation


def _encode_table(values: np.ndarray,
                  table: Dict[str, List[int]]) -> np.ndarray:
    """Map an (N, 6) string array through an encoding table to
    (N, 6, C) int64; an unknown label raises KeyError."""
    keys = np.array(sorted(table.keys()))
    rows = np.array([table[k] for k in keys], dtype=np.int64)
    flat = values.ravel()
    idx = np.searchsorted(keys, flat)
    bad = (idx >= len(keys)) | (keys[np.clip(idx, 0, len(keys) - 1)] != flat)
    if bad.any():
        raise KeyError(f"unknown label(s): {sorted(set(flat[bad]))}")
    return rows[idx].reshape(*values.shape, rows.shape[-1])


def encode_identity(df: Annotation) -> np.ndarray:
    """(N, 6) presence bits: 1 where user_i_location is given (int8)."""
    return (df.matrix(USER_LOCATION_COLS) != "nan").astype(np.int8)


def encode_activity(df: Annotation,
                    table: Optional[Dict[str, List[int]]] = None
                    ) -> np.ndarray:
    """(N, 6, 9) activity one-hots; absent users encode to all-zero."""
    return _encode_table(df.matrix(USER_ACTIVITY_COLS),
                         table or ACTIVITY_ENCODING)


def encode_location(df: Annotation,
                    table: Optional[Dict[str, List[int]]] = None
                    ) -> np.ndarray:
    """(N, 6, 5) location one-hots; absent users encode to all-zero."""
    return _encode_table(df.matrix(USER_LOCATION_COLS),
                         table or LOCATION_ENCODING)


def encode_labels(df: Annotation, task: str,
                  activity_table: Optional[Dict[str, List[int]]] = None,
                  location_table: Optional[Dict[str, List[int]]] = None
                  ) -> np.ndarray:
    """Task dispatch (reference wifi_csi/load_data.py:82-107)."""
    if task == "identity":
        return encode_identity(df)
    if task == "activity":
        return encode_activity(df, activity_table)
    if task == "location":
        return encode_location(df, location_table)
    raise ValueError(f"unknown task: {task}")


def reduce_dataset(data: np.ndarray,
                   num_object_queries: Optional[int] = None) -> np.ndarray:
    """(N, 6, C) one-hots to (N, Q, C+1) set-prediction targets, as the
    module docstring says. If no row is all-zero, row 0 is deleted (the
    reference's argmax of an all-False mask), as in JAX."""
    data = np.asarray(data)
    n, users, classes = data.shape
    row_is_zero = data.sum(axis=2) == 0                     # (N, 6)
    drop = row_is_zero.argmax(axis=1)                       # first zero row
    keep = np.arange(users)[None, :] != drop[:, None]
    kept = data[keep].reshape(n, users - 1, classes)        # (N, 5, C)
    out = np.concatenate(
        [kept, np.zeros((n, users - 1, 1), dtype=kept.dtype)], axis=2)
    no_person = np.zeros(classes + 1, dtype=out.dtype)
    no_person[-1] = 1
    out[out.sum(axis=2) == 0] = no_person
    if num_object_queries:
        pad = np.broadcast_to(
            no_person,
            (n, num_object_queries - (users - 1), classes + 1)).copy()
        out = np.concatenate([out, pad], axis=1)
    return out
