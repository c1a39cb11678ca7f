"""Result serialisation (reference ``utils.py:185-193`` NumpyEncoder; the
port's copy of the JAX package's ``utils/results.py``)."""

from __future__ import annotations

import json

import numpy as np


class NumpyJSONEncoder(json.JSONEncoder):
    """JSON for numpy scalars and arrays, and for anything with a scalar
    ``item()`` (a one-element tensor)."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if hasattr(obj, "item"):
            try:
                return obj.item()
            except Exception:
                pass
        return super().default(obj)
