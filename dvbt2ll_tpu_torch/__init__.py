"""dvbt2ll_tpu_torch: the DVB-T2 transmit chain in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of ``dvbt2ll_tpu`` (JAX on a TPU), which stays the reference.  The
port stands alone: it keeps its own copies of the host-side planner
(``config``, ``plan``, ``tables``, ``io``, ``observability``), imports
``torch`` and never ``jax``, and nothing of ``dvbt2ll_tpu``.
"""
from .io import synthetic_ts
from .config import (PAPR, Bandwidth, CarrierMode, CodeRate, Constellation,
                     FFTSize, FrameSize, GuardInterval, InBand, InputMode,
                     L1Constellation, MisoGroup, PilotPattern, PLPConfig,
                     Preamble, Rotation, T2Config, Version, named_config,
                     vv009_config)
from .convert import plan_tensors
from .executor import StreamingExecutor
from .parallel import (DeviceMesh, MultiMuxTransmitter, MuxChannel,
                       ShardedTransmitter, grids_symbol_sharded, halo_windows,
                       make_mesh)
from .pipeline import (Transmitter, bb_and_fec, transmit_step,
                       transmit_step_iq, transmit_step_iq_planar)
from .plan import TransmitPlan, build_plan, min_batch_frames

__all__ = [
    "T2Config", "PLPConfig", "named_config", "vv009_config", "Transmitter",
    "TransmitPlan", "build_plan", "min_batch_frames", "plan_tensors",
    "bb_and_fec", "transmit_step", "transmit_step_iq",
    "transmit_step_iq_planar",
    "StreamingExecutor", "synthetic_ts", "DeviceMesh", "MultiMuxTransmitter",
    "MuxChannel", "ShardedTransmitter", "grids_symbol_sharded",
    "halo_windows", "make_mesh",
    "Bandwidth", "CarrierMode", "CodeRate", "Constellation", "FFTSize",
    "FrameSize", "GuardInterval", "InBand", "InputMode", "L1Constellation",
    "MisoGroup", "PAPR", "PilotPattern", "Preamble", "Rotation", "Version",
]
