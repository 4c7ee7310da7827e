"""The JAX package's host-side planner, loaded without its ``__init__``.

``dvbt2ll_tpu/__init__.py`` imports ``pipeline`` and so ``jax``, which the
machine with the GPU does not have.  The planner itself (``config``,
``plan``, ``tables``, ``io``, ``observability``) is pure numpy, and it must
stay one source of truth for both packages.  Pointing this package's
``__path__`` at ``dvbt2ll_tpu/`` makes ``dvbt2ll_tpu_torch._host.config``
and its siblings the JAX package's own files, imported under this
package's name, so their relative imports resolve here too.

Never import ``_host.pipeline``, ``_host.ops``, ``_host.parallel`` or
``_host.executor``: they import jax.
"""
import os

__path__ = [os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "dvbt2ll_tpu")]
