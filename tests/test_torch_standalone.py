"""The port stands alone: it loads nothing of the JAX package, builds its
native libraries inside its own tree, and its copy of the host planner
(``config``, ``plan``, ``tables``) gives what the JAX package's gives.

Run alone: ``python -m pytest tests/test_torch_standalone.py -q``.
"""
import dataclasses
import enum
import functools
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from dvbt2ll_tpu import config as jax_config
from dvbt2ll_tpu.plan import build_plan as jax_build_plan
from dvbt2ll_tpu_torch import config
from dvbt2ll_tpu_torch.plan import build_plan, min_batch_frames

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

# imports every module of the port and chip_smoke.py with jax made
# unimportable, builds the native ingest ring and sink, and prints what
# would break the port's independence
_ALONE = r"""
import os, pkgutil, sys
sys.modules["jax"] = None
root = sys.argv[1]
jax_pkg = os.path.join(root, "dvbt2ll_tpu") + os.sep

def so_files():
    out = {}
    for d, _, files in os.walk(jax_pkg):
        for f in files:
            if f.endswith(".so"):
                p = os.path.join(d, f)
                out[p] = os.stat(p).st_mtime_ns
    return out

before = so_files()
import dvbt2ll_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dvbt2ll_tpu_torch.__path__,
                                               "dvbt2ll_tpu_torch.")]
for name in names:
    __import__(name)
import chip_smoke
from dvbt2ll_tpu_torch.io import ingest, native_sink
built = [ingest._load() and ingest._LIB_CACHE,
         native_sink._load() and native_sink._LIB_CACHE]
bad = sorted(m for m in sys.modules
             if m == "dvbt2ll_tpu" or m.startswith("dvbt2ll_tpu."))
files = sorted(getattr(m, "__file__", None) or "" for m in
               list(sys.modules.values()))
under = [f for f in files if os.path.abspath(f).startswith(jax_pkg)]
port_build = os.path.join(root, "dvbt2ll_tpu_torch", "_build") + os.sep
print("modules", len(names))
print("jax_modules", bad)
print("jax_files", under)
print("so_changed", sorted(set(so_files().items()) - set(before.items())))
print("built_in_port", all(p.startswith(port_build) and os.path.exists(p)
                           for p in built))
"""


def test_port_loads_nothing_of_the_jax_package():
    """Every module of the port and ``chip_smoke.py``, imported with jax
    unimportable: no ``dvbt2ll_tpu`` module in ``sys.modules``, no loaded
    file under ``dvbt2ll_tpu/``; the native ingest ring and sink build
    into ``dvbt2ll_tpu_torch/_build/`` and no ``*.so`` under
    ``dvbt2ll_tpu/`` is written."""
    if shutil.which("g++") is None:
        pytest.skip("the native ingest ring and sink build with g++")
    env = dict(os.environ, PYTHONPATH=_ROOT, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", _ALONE, _ROOT], cwd=_ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    said = dict(line.split(" ", 1) for line in res.stdout.splitlines())
    assert int(said["modules"]) > 20, said
    assert said["jax_modules"] == "[]", said
    assert said["jax_files"] == "[]", said
    assert said["so_changed"] == "[]", said
    assert said["built_in_port"] == "True", said


def _same(a, b, where: str) -> None:
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
            _same(getattr(a, f.name), getattr(b, f.name),
                  f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif hasattr(a, "__dict__"):
        assert type(a).__name__ == type(b).__name__, where
        _same(vars(a), vars(b), where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@functools.lru_cache(maxsize=1)
def _bench():
    """``bench.py``, the JAX package's named-config registry."""
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(_ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _properties(cls) -> list:
    return sorted(n for n in dir(cls) if not n.startswith("_")
                  and isinstance(getattr(cls, n),
                                 (property, functools.cached_property)))


@pytest.mark.parametrize("name", config.NAMED_CONFIGS)
def test_plan_equals_the_jax_packages(name):
    """The port's config (fields and every derived property) and its
    plan of two frames (HIEFF: its smallest batch of whole packets) equal
    the JAX package's, field for field."""
    ours = config.named_config(name)
    theirs = _bench()._named_config(name)
    _same(ours, theirs, name)
    props = _properties(config.T2Config)
    assert props == _properties(jax_config.T2Config)
    for p in props:
        _same(getattr(ours, p), getattr(theirs, p), f"{name}.{p}")
    batch = (min_batch_frames(ours)
             if ours.input_mode == config.InputMode.HIEFF else 2)
    _same(build_plan(ours, batch, strict=False),
          jax_build_plan(theirs, batch, strict=False), f"{name} plan")


_INVALID = [dict(sub_slices=2), dict(fef_length=1000, fef_interval=1)]


@pytest.mark.parametrize("kw", _INVALID, ids=["sub_slices", "fef_length"])
def test_validate_refuses_with_the_same_text(kw):
    msgs = []
    for mod in (config, jax_config):
        with pytest.raises(ValueError) as e:
            mod.T2Config(**kw).validate()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
