"""The host-built transmit plan: the JAX package's ``plan`` through
``_host`` (one source of truth for every static table)."""
from ._host.plan import (PlpPlan, TransmitPlan, build_plan,  # noqa: F401
                         min_batch_frames)
