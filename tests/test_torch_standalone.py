"""The port stands alone: it loads nothing of the JAX package, builds its
native libraries inside its own tree, and its copy of the host planner
(``config``, ``plan``, ``tables``) gives what the JAX package's gives.

Run alone: ``python -m pytest tests/test_torch_standalone.py -q``.
"""
import functools
import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

from dvbt2ll_tpu import config as jax_config
from dvbt2ll_tpu.plan import build_plan as jax_build_plan
from dvbt2ll_tpu_torch import config
from dvbt2ll_tpu_torch.plan import build_plan, min_batch_frames
from tests.torch_compare import jax_named_config, properties, same

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


@functools.lru_cache(maxsize=1)
def _bench():
    """``bench.py``, the JAX package's named-config registry."""
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(_ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", config.NAMED_CONFIGS)
def test_plan_equals_the_jax_packages(name):
    """The port's config (fields and every derived property) and its
    plan of two frames (HIEFF: its smallest batch of whole packets) equal
    the JAX package's, field for field."""
    ours = config.named_config(name)
    theirs = jax_named_config(_bench()._named_config, name)
    same(ours, theirs, name)
    props = properties(config.T2Config)
    assert props == properties(jax_config.T2Config)
    for p in props:
        same(getattr(ours, p), getattr(theirs, p), f"{name}.{p}")
    batch = (min_batch_frames(ours)
             if ours.input_mode == config.InputMode.HIEFF else 2)
    same(build_plan(ours, batch, strict=False),
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
