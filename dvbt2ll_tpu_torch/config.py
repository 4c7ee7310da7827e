"""Transmitter configuration: the JAX package's ``config`` (through
``_host``) plus the named configurations the port runs.

Either package's ``T2Config`` drives either planner: the planner makes
no ``isinstance`` or identity checks on configs, and its enums are
``IntEnum``s, which compare and hash by value.
"""
from ._host.config import (Bandwidth, CarrierMode, CodeRate,  # noqa: F401
                           Constellation, FFTSize, FrameSize, GuardInterval,
                           InBand, InputMode, L1Constellation, MisoGroup,
                           PAPR, PilotPattern, PLPConfig, Preamble, Rotation,
                           T2Config, Version, vv009_config)

NAMED_CONFIGS = ("vv009_4kshort", "8k_normal")


def named_config(name: str) -> T2Config:
    """The configurations of ``bench.py:_named_config`` that this slice
    runs, with the same values (that registry imports the JAX package)."""
    if name == "vv009_4kshort":
        return vv009_config()
    if name == "8k_normal":
        return T2Config(
            frame_size=FrameSize.NORMAL, code_rate=CodeRate.C2_3,
            constellation=Constellation.QAM64, rotation=Rotation.OFF,
            fft_size=FFTSize.FFT_8K, guard_interval=GuardInterval.GI_1_16,
            pilot_pattern=PilotPattern.PP3, fec_blocks=2, ti_blocks=1,
            t2_frames=2, num_data_symbols=8).validate()
    raise ValueError(f"unknown config {name!r}; known: {NAMED_CONFIGS}")
