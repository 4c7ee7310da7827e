"""Standards tables (EN 302 755) and host-side table construction.

`data/standards.npz` holds the raw integer tables machine-extracted from the
reference sources (see tools/extract_tables.py for provenance and citations);
the modules here turn them into dense numpy structures (GF(2) generator
matrices, gather index planes, pilot planes).  A frozen copy of the JAX
package's ``tables/`` for the benchmark's plain reference.
"""
import functools
import json
import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@functools.lru_cache(maxsize=1)
def standards():
    """All raw standards tables as a dict of numpy int64 arrays."""
    with np.load(os.path.join(_DATA_DIR, "standards.npz")) as z:
        return dict(z)


@functools.lru_cache(maxsize=1)
def cp_recipe():
    """Continual-pilot application recipe: list of
    {fft, pattern, table, count, mod, extended_only} dicts."""
    with open(os.path.join(_DATA_DIR, "cp_recipe.json")) as f:
        return json.load(f)


def table(name: str) -> np.ndarray:
    return standards()[name]
