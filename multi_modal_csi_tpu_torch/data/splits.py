"""Seeded dataset splits, without sklearn: the port's copy of the JAX
package's ``data/splits.py``.

The reference splits each environment with sklearn's
``train_test_split(test_size=0.2, shuffle=True, random_state=103)`` and
then, in the THAT and DETR runners, the test part 50/50 into validation
and test with ``random_state=39`` (reference ``wifi_csi/run_main.py:20-66``,
``model/that.py:332-335``, ``model/detr.py:660-663``). That function draws
``np.random.RandomState(seed).permutation(n)``, gives the first
``ceil(test_size * n)`` indices to the test part and the rest, in
permutation order, to the training part; ``train_test_split`` here does
the same, so the port evaluates the same windows as JAX and the reference.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

ENV_SPLIT_SEED = 103    # run_main.py:52
VALID_SPLIT_SEED = 39   # that.py:335 / detr.py:663

Split = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def train_test_split(x: np.ndarray, y: np.ndarray, test_size: float,
                     seed: int) -> Split:
    """(x_train, x_test, y_train, y_test), as sklearn's
    ``train_test_split(x, y, test_size=test_size, shuffle=True,
    random_state=seed)`` with a float ``test_size`` in (0, 1)."""
    n = len(x)
    if len(y) != n:
        raise ValueError(f"x has {n} rows and y {len(y)}")
    n_test = math.ceil(test_size * n)
    if not 0 < n_test < n:
        raise ValueError(f"test_size {test_size} of {n} samples leaves an "
                         f"empty part")
    perm = np.random.RandomState(seed).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    return x[train], x[test], y[train], y[test]


def env_split(x: np.ndarray, y: np.ndarray, test_size: float = 0.2,
              seed: int = ENV_SPLIT_SEED) -> Split:
    """80/20 split of one environment's samples (x_train, x_test, y_train,
    y_test)."""
    return train_test_split(x, y, test_size, seed)


def valid_test_split(x: np.ndarray, y: np.ndarray,
                     seed: int = VALID_SPLIT_SEED) -> Split:
    """50/50 split used by the THAT and DETR families: (x_valid, x_test,
    y_valid, y_test), in the reference's order."""
    return train_test_split(x, y, 0.5, seed)


def concat_env_splits(per_env: Sequence[Split]) -> Split:
    """Concatenate per-environment (x_tr, x_te, y_tr, y_te) tuples:
    splitting per environment keeps any environment's windows from
    crossing between training and test."""
    xs_tr, xs_te, ys_tr, ys_te = zip(*per_env)
    return (np.concatenate(xs_tr, axis=0), np.concatenate(xs_te, axis=0),
            np.concatenate(ys_tr, axis=0), np.concatenate(ys_te, axis=0))
