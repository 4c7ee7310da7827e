"""Transmitter configuration: the JAX package's ``config`` (through
``_host``) plus the named configurations of ``bench.py:_named_config``.

Either package's ``T2Config`` drives either planner: the planner makes
no ``isinstance`` or identity checks on configs, and its enums are
``IntEnum``s, which compare and hash by value.
"""
from ._host.config import (Bandwidth, CarrierMode, CodeRate,  # noqa: F401
                           Constellation, FFTSize, FrameSize, GuardInterval,
                           InBand, InputMode, L1Constellation, MisoGroup,
                           PAPR, PilotPattern, PLPConfig, Preamble, Rotation,
                           T2Config, Version, vv009_config)

NAMED_CONFIGS = (
    "vv009_4kshort", "8k_normal", "32k_extended", "hieff_4k", "inband_2k",
    "8k_miso_tx1", "8k_miso_tx2", "16k_l1qpsk_both", "1k_pp4",
    "qpsk_short_c13", "ti_off_4k", "t2lite_4k", "t2lite_8k_t2gi_miso",
    "t2lite_16k_t2gi", "v121_4k", "multiplp_fef", "eq_2k_5mhz",
    "32k_papr_tr")


def named_config(name: str) -> T2Config:
    """The registry of ``bench.py:_named_config``, name for name and value
    for value (that module imports the JAX package).  The BASELINE.json
    matrix (vv009_4kshort, 8k_normal, 32k_extended, multiplp_fef) plus one
    config per reference work-loop branch with a reference-binary golden
    in ``tests/golden_ref``; see ``bench.py`` for what each one pins."""
    if name == "vv009_4kshort":
        return vv009_config()
    if name == "8k_normal":
        return T2Config(
            frame_size=FrameSize.NORMAL, code_rate=CodeRate.C2_3,
            constellation=Constellation.QAM64, rotation=Rotation.OFF,
            fft_size=FFTSize.FFT_8K, guard_interval=GuardInterval.GI_1_16,
            pilot_pattern=PilotPattern.PP3, fec_blocks=2, ti_blocks=1,
            t2_frames=2, num_data_symbols=8).validate()
    if name == "32k_extended":
        return T2Config(
            frame_size=FrameSize.NORMAL, code_rate=CodeRate.C4_5,
            constellation=Constellation.QAM256, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_32K, guard_interval=GuardInterval.GI_1_32,
            pilot_pattern=PilotPattern.PP7, carrier_mode=CarrierMode.EXTENDED,
            fec_blocks=4, ti_blocks=2, t2_frames=2,
            num_data_symbols=4).validate()
    if name == "hieff_4k":
        return T2Config(
            frame_size=FrameSize.NORMAL, code_rate=CodeRate.C4_5,
            constellation=Constellation.QAM256, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_4K, guard_interval=GuardInterval.GI_1_32,
            pilot_pattern=PilotPattern.PP7, fec_blocks=1, ti_blocks=1,
            t2_frames=2, num_data_symbols=3,
            input_mode=InputMode.HIEFF).validate()
    if name == "inband_2k":
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C4_5,
            constellation=Constellation.QPSK, rotation=Rotation.OFF,
            fft_size=FFTSize.FFT_2K, guard_interval=GuardInterval.GI_1_8,
            pilot_pattern=PilotPattern.PP1, fec_blocks=2, ti_blocks=1,
            t2_frames=2, num_data_symbols=8,
            l1_constellation=L1Constellation.BPSK,
            in_band=InBand.ON, ts_rate=4_000_000).validate()
    if name in ("8k_miso_tx1", "8k_miso_tx2"):
        return T2Config(
            frame_size=FrameSize.NORMAL, code_rate=CodeRate.C2_3,
            constellation=Constellation.QAM64, rotation=Rotation.OFF,
            fft_size=FFTSize.FFT_8K, guard_interval=GuardInterval.GI_1_16,
            pilot_pattern=PilotPattern.PP3, carrier_mode=CarrierMode.EXTENDED,
            preamble=Preamble.T2_MISO,
            miso_group=(MisoGroup.TX1 if name.endswith("tx1")
                        else MisoGroup.TX2),
            fec_blocks=2, ti_blocks=1, t2_frames=2,
            num_data_symbols=8).validate()
    if name == "16k_l1qpsk_both":
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C2_3,
            constellation=Constellation.QAM16, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_16K, guard_interval=GuardInterval.GI_1_16,
            pilot_pattern=PilotPattern.PP3, carrier_mode=CarrierMode.EXTENDED,
            papr=PAPR.BOTH, l1_constellation=L1Constellation.QPSK,
            fec_blocks=2, ti_blocks=1, t2_frames=2,
            num_data_symbols=6).validate()
    if name == "1k_pp4":
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C2_3,
            constellation=Constellation.QPSK, rotation=Rotation.OFF,
            fft_size=FFTSize.FFT_1K, guard_interval=GuardInterval.GI_1_8,
            pilot_pattern=PilotPattern.PP4,
            l1_constellation=L1Constellation.QAM16,
            fec_blocks=1, ti_blocks=1, t2_frames=2,
            num_data_symbols=16).validate()
    if name == "qpsk_short_c13":
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C1_3,
            constellation=Constellation.QPSK, rotation=Rotation.OFF,
            fft_size=FFTSize.FFT_2K, guard_interval=GuardInterval.GI_1_8,
            pilot_pattern=PilotPattern.PP1,
            l1_constellation=L1Constellation.BPSK,
            fec_blocks=2, ti_blocks=1, t2_frames=2,
            num_data_symbols=8).validate()
    if name == "ti_off_4k":
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C4_5,
            constellation=Constellation.QAM256, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_4K, guard_interval=GuardInterval.GI_1_32,
            pilot_pattern=PilotPattern.PP7, fec_blocks=8, ti_blocks=0,
            t2_frames=2, num_data_symbols=3).validate()
    if name == "t2lite_4k":
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C2_3,
            constellation=Constellation.QAM16, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_4K, guard_interval=GuardInterval.GI_1_32,
            pilot_pattern=PilotPattern.PP7, preamble=Preamble.T2_LITE_SISO,
            version=Version.V131, l1_constellation=L1Constellation.QPSK,
            fec_blocks=2, ti_blocks=1, t2_frames=2,
            num_data_symbols=3).validate()
    if name == "t2lite_8k_t2gi_miso":
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C3_5,
            constellation=Constellation.QPSK, rotation=Rotation.OFF,
            fft_size=FFTSize.FFT_8K_T2GI,
            guard_interval=GuardInterval.GI_19_128,
            pilot_pattern=PilotPattern.PP3, preamble=Preamble.T2_LITE_MISO,
            miso_group=MisoGroup.TX2, version=Version.V131,
            l1_constellation=L1Constellation.BPSK,
            fec_blocks=1, ti_blocks=1, t2_frames=2,
            num_data_symbols=4).validate()
    if name == "t2lite_16k_t2gi":
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C2_5,
            constellation=Constellation.QAM16, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_16K_T2GI,
            guard_interval=GuardInterval.GI_19_256,
            pilot_pattern=PilotPattern.PP3, preamble=Preamble.T2_LITE_SISO,
            version=Version.V131, l1_constellation=L1Constellation.QPSK,
            fec_blocks=6, ti_blocks=2, t2_frames=2,
            num_data_symbols=3).validate()
    if name == "v121_4k":
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C4_5,
            constellation=Constellation.QAM256, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_4K, guard_interval=GuardInterval.GI_1_32,
            pilot_pattern=PilotPattern.PP7, version=Version.V121,
            fec_blocks=3, ti_blocks=1, t2_frames=2,
            num_data_symbols=3).validate()
    if name == "multiplp_fef":
        # two type-1 data PLPs with mixed code rates and constellations,
        # plus FEF parts
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C4_5,
            constellation=Constellation.QAM256, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_4K, guard_interval=GuardInterval.GI_1_32,
            pilot_pattern=PilotPattern.PP7,
            plps=(
                PLPConfig(plp_id=0, code_rate=CodeRate.C4_5,
                          constellation=Constellation.QAM256,
                          rotation=Rotation.ON, frame_size=FrameSize.SHORT,
                          fec_blocks=4, ti_blocks=2),
                PLPConfig(plp_id=1, code_rate=CodeRate.C1_2,
                          constellation=Constellation.QAM16,
                          rotation=Rotation.OFF, frame_size=FrameSize.SHORT,
                          fec_blocks=2, ti_blocks=1),
            ),
            fec_blocks=4, ti_blocks=2, t2_frames=2, num_data_symbols=3,
            fef_length=4096, fef_interval=2).validate()
    if name == "eq_2k_5mhz":
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C2_3,
            constellation=Constellation.QAM16, rotation=Rotation.OFF,
            fft_size=FFTSize.FFT_2K, guard_interval=GuardInterval.GI_1_8,
            pilot_pattern=PilotPattern.PP1,
            l1_constellation=L1Constellation.BPSK,
            fec_blocks=2, ti_blocks=1, t2_frames=2, num_data_symbols=8,
            equalization=True, bandwidth=Bandwidth.BW_5_0_MHZ).validate()
    if name == "32k_papr_tr":
        return T2Config(
            frame_size=FrameSize.NORMAL, code_rate=CodeRate.C4_5,
            constellation=Constellation.QAM256, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_32K, guard_interval=GuardInterval.GI_1_32,
            pilot_pattern=PilotPattern.PP7, carrier_mode=CarrierMode.EXTENDED,
            papr=PAPR.TR, fec_blocks=4, ti_blocks=2, t2_frames=2,
            num_data_symbols=4).validate()
    raise ValueError(f"unknown config {name!r}; known: {NAMED_CONFIGS}")
