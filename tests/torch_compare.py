"""Comparisons shared by the port's tests: a port object against the JAX
package's, field by field, and the SNR of one IQ stream against another."""
import dataclasses
import enum
import functools

import numpy as np


def same(a, b, where: str) -> None:
    """a (the port's) equals b (the JAX package's): arrays by dtype,
    shape and value; enums by name and value; dataclasses and plain
    objects field by field."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, enum.Enum):
        assert (type(a).__name__, a.name, a.value) == (
            type(b).__name__, b.name, b.value), where
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name),
                 f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
    elif hasattr(a, "__dict__"):
        assert type(a).__name__ == type(b).__name__, where
        same(vars(a), vars(b), where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def jax_named_config(named, name: str):
    """The JAX package's config of ``name`` from ``named``, its registry
    (``bench.py``'s ``_named_config``); for a name of the port's registry
    that ``bench.py`` lacks (it exits with "unknown config"), the JAX
    package's ``T2Config`` read from the port's JSON document of that
    name."""
    try:
        return named(name)
    except SystemExit as e:
        if not str(e).startswith("unknown config"):
            raise
    from dvbt2ll_tpu.config import T2Config
    from dvbt2ll_tpu_torch.config import named_config
    return T2Config.from_json(named_config(name).to_json())


def properties(cls) -> list:
    """The public derived properties of a config class, by name."""
    return sorted(n for n in dir(cls) if not n.startswith("_")
                  and isinstance(getattr(cls, n),
                                 (property, functools.cached_property)))


def snr_db(ref, x) -> float:
    """SNR of ``x`` against ``ref`` in dB (inf when equal)."""
    ref = np.asarray(ref, np.complex128).ravel()
    x = np.asarray(x, np.complex128).ravel()
    err = np.sum(np.abs(x - ref) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(np.abs(ref) ** 2)
                                                 / err)
