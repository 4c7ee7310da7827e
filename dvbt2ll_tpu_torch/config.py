"""DVB-T2 transmit configuration (EN 302 755 V1.3.1).

One frozen :class:`T2Config` derives every constant that the reference
implementation (gr-dvbt2ll) recomputes in four separate block constructors
(`lib/bbheaderbch_bb_impl.cc:42-196`, `lib/interleavermod_bc_impl.cc:42-255`,
`lib/framemapperfint_cc_impl.cc:41-1190`, `lib/pilotgenp1insert_cc_impl.cc:43-1229`).
The reference leaves cross-block consistency to the user; here a single config
object feeds every stage, so the chain cannot disagree with itself.

Enum integer values follow the reference's public enums
(`include/dvbt2ll/dvbt2ll_config.h:58-227`) because several of them are
serialized verbatim into L1 signalling fields.

The port's own copy of ``dvbt2ll_tpu/config.py`` (the same fields, enums,
derived properties and ``validate()`` messages; tests/test_torch_standalone.py
and tests/test_torch_config.py hold the two equal), plus the named
configurations of ``bench.py:_named_config``.  One rule is the port's own:
``validate()`` refuses a frame of more OFDM symbols than the PN sequence has
chips, which the JAX package accepts and then cannot plan.
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from enum import IntEnum
from functools import cached_property

# chips of the per-symbol PN sequence (tables/sequences.py::pn_sequence):
# the most OFDM symbols a T2 frame can have
PN_CHIPS = 2624


class CodeRate(IntEnum):
    C1_2 = 0
    C3_5 = 1
    C2_3 = 2
    C3_4 = 3
    C4_5 = 4
    C5_6 = 5
    C1_3 = 6
    C2_5 = 7


class Constellation(IntEnum):
    QPSK = 0
    QAM16 = 1
    QAM64 = 2
    QAM256 = 3


class Rotation(IntEnum):
    OFF = 0
    ON = 1


class FrameSize(IntEnum):
    SHORT = 0
    NORMAL = 1


class InputMode(IntEnum):
    NORMAL = 0
    HIEFF = 1


class CarrierMode(IntEnum):
    NORMAL = 0
    EXTENDED = 1


class Preamble(IntEnum):
    T2_SISO = 0
    T2_MISO = 1
    NON_T2 = 2
    T2_LITE_SISO = 3
    T2_LITE_MISO = 4


class FFTSize(IntEnum):
    FFT_2K = 0
    FFT_8K = 1
    FFT_4K = 2
    FFT_1K = 3
    FFT_16K = 4
    FFT_32K = 5
    FFT_8K_T2GI = 6
    FFT_32K_T2GI = 7
    FFT_16K_T2GI = 11


class GuardInterval(IntEnum):
    GI_1_32 = 0
    GI_1_16 = 1
    GI_1_8 = 2
    GI_1_4 = 3
    GI_1_128 = 4
    GI_19_128 = 5
    GI_19_256 = 6


class PAPR(IntEnum):
    OFF = 0
    ACE = 1
    TR = 2
    BOTH = 3


class L1Constellation(IntEnum):
    BPSK = 0
    QPSK = 1
    QAM16 = 2
    QAM64 = 3


class PilotPattern(IntEnum):
    PP1 = 0
    PP2 = 1
    PP3 = 2
    PP4 = 3
    PP5 = 4
    PP6 = 5
    PP7 = 6
    PP8 = 7


class Version(IntEnum):
    V111 = 0
    V121 = 1
    V131 = 2


class MisoGroup(IntEnum):
    TX1 = 0
    TX2 = 1


class InBand(IntEnum):
    OFF = 0
    ON = 1


class Bandwidth(IntEnum):
    BW_1_7_MHZ = 0
    BW_5_0_MHZ = 1
    BW_6_0_MHZ = 2
    BW_7_0_MHZ = 3
    BW_8_0_MHZ = 4
    BW_10_0_MHZ = 5


FRAME_SIZE_NORMAL = 64800
FRAME_SIZE_SHORT = 16200

# L1 FEC constants (EN 302 755 section 7.3; reference
# lib/framemapperfint_cc_impl.h:26-33)
KBCH_1_4 = 3072
NBCH_1_4 = 3240
KBCH_1_2 = 7032
NBCH_1_2 = 7200
KSIG_PRE = 200
KSIG_POST = 350
NBCH_PARITY = 168
N_L1PRE_CELLS = 1840  # KSIG_PRE + NBCH_PARITY + (12960 - 11488) unpunctured

# ---------------------------------------------------------------------------
# FEC parameters: (frame size, code rate) -> (kbch, nbch=kldpc, q, bch_t)
# EN 302 755 tables 6a/6b; reference lib/bbheaderbch_bb_impl.cc:51-150.
# bch_t is the error-correction capability (number of minimal polynomials).
# ---------------------------------------------------------------------------
_FEC_NORMAL = {
    CodeRate.C1_2: (32208, 32400, 90, 12),
    CodeRate.C3_5: (38688, 38880, 72, 12),
    CodeRate.C2_3: (43040, 43200, 60, 10),
    CodeRate.C3_4: (48408, 48600, 45, 12),
    CodeRate.C4_5: (51648, 51840, 36, 12),
    CodeRate.C5_6: (53840, 54000, 30, 10),
}
_FEC_SHORT = {
    CodeRate.C1_3: (5232, 5400, 30, 12),
    CodeRate.C2_5: (6312, 6480, 27, 12),
    CodeRate.C1_2: (7032, 7200, 25, 12),
    CodeRate.C3_5: (9552, 9720, 18, 12),
    CodeRate.C2_3: (10632, 10800, 15, 12),
    CodeRate.C3_4: (11712, 11880, 12, 12),
    CodeRate.C4_5: (12432, 12600, 10, 12),
    CodeRate.C5_6: (13152, 13320, 8, 12),
}

# cells per FEC frame: (frame size, constellation) -> cell_size
# reference lib/interleavermod_bc_impl.cc:131-168
_CELLS = {
    (FrameSize.NORMAL, Constellation.QPSK): 32400,
    (FrameSize.NORMAL, Constellation.QAM16): 16200,
    (FrameSize.NORMAL, Constellation.QAM64): 10800,
    (FrameSize.NORMAL, Constellation.QAM256): 8100,
    (FrameSize.SHORT, Constellation.QPSK): 8100,
    (FrameSize.SHORT, Constellation.QAM16): 4050,
    (FrameSize.SHORT, Constellation.QAM64): 2700,
    (FrameSize.SHORT, Constellation.QAM256): 2025,
}

_MOD_BITS = {
    Constellation.QPSK: 2,
    Constellation.QAM16: 4,
    Constellation.QAM64: 6,
    Constellation.QAM256: 8,
}

# base FFT size key ("1K".."32K") for each FFTSize enum
_FFT_KEY = {
    FFTSize.FFT_1K: "1K",
    FFTSize.FFT_2K: "2K",
    FFTSize.FFT_4K: "4K",
    FFTSize.FFT_8K: "8K",
    FFTSize.FFT_8K_T2GI: "8K",
    FFTSize.FFT_16K: "16K",
    FFTSize.FFT_16K_T2GI: "16K",
    FFTSize.FFT_32K: "32K",
    FFTSize.FFT_32K_T2GI: "32K",
}
_FFT_POINTS = {"1K": 1024, "2K": 2048, "4K": 4096, "8K": 8192,
               "16K": 16384, "32K": 32768}

# P2 symbols: fft key -> (N_P2, C_P2_siso, C_P2_miso)
# reference lib/framemapperfint_cc_impl.cc:295-356
_P2 = {
    "1K": (16, 558, 546),
    "2K": (8, 1118, 1098),
    "4K": (4, 2236, 2198),
    "8K": (2, 4472, 4398),
    "16K": (1, 8944, 8814),
    "32K": (1, 22432, 17612),
}

# carrier structure: fft key -> {carrier mode: (C_PS, K_EXT, K_OFFSET)}
# reference lib/pilotgenp1insert_cc_impl.cc:120-175
_CARRIERS = {
    "1K": {CarrierMode.NORMAL: (853, 0, 0)},
    "2K": {CarrierMode.NORMAL: (1705, 0, 0)},
    "4K": {CarrierMode.NORMAL: (3409, 0, 0)},
    "8K": {CarrierMode.NORMAL: (6817, 0, 48),
           CarrierMode.EXTENDED: (6913, 48, 0)},
    "16K": {CarrierMode.NORMAL: (13633, 0, 144),
            CarrierMode.EXTENDED: (13921, 144, 0)},
    "32K": {CarrierMode.NORMAL: (27265, 0, 288),
            CarrierMode.EXTENDED: (27841, 288, 0)},
}

# data cells per symbol: (fft key, extended) -> {pattern: (C_DATA, N_FC, C_FC)}
# EN 302 755 tables 42-45; reference lib/framemapperfint_cc_impl.cc:425-897.
# All-zero entries are invalid (fft, pattern) combinations.
_Z = (0, 0, 0)
_CDATA = {
    ("1K", False): {
        PilotPattern.PP1: (764, 568, 402), PilotPattern.PP2: (768, 710, 654),
        PilotPattern.PP3: (798, 710, 490), PilotPattern.PP4: (804, 780, 707),
        PilotPattern.PP5: (818, 780, 544), PilotPattern.PP6: _Z,
        PilotPattern.PP7: _Z, PilotPattern.PP8: _Z,
    },
    ("2K", False): {
        PilotPattern.PP1: (1522, 1136, 804), PilotPattern.PP2: (1532, 1420, 1309),
        PilotPattern.PP3: (1596, 1420, 980), PilotPattern.PP4: (1602, 1562, 1415),
        PilotPattern.PP5: (1632, 1562, 1088), PilotPattern.PP6: _Z,
        PilotPattern.PP7: (1646, 1632, 1396), PilotPattern.PP8: _Z,
    },
    ("4K", False): {
        PilotPattern.PP1: (3084, 2272, 1609), PilotPattern.PP2: (3092, 2840, 2619),
        PilotPattern.PP3: (3228, 2840, 1961), PilotPattern.PP4: (3234, 3124, 2831),
        PilotPattern.PP5: (3298, 3124, 2177), PilotPattern.PP6: _Z,
        PilotPattern.PP7: (3328, 3266, 2792), PilotPattern.PP8: _Z,
    },
    ("8K", False): {
        PilotPattern.PP1: (6208, 4544, 3218), PilotPattern.PP2: (6214, 5680, 5238),
        PilotPattern.PP3: (6494, 5680, 3922), PilotPattern.PP4: (6498, 6248, 5662),
        PilotPattern.PP5: (6634, 6248, 4354), PilotPattern.PP6: _Z,
        PilotPattern.PP7: (6698, 6532, 5585), PilotPattern.PP8: (6698, 0, 0),
    },
    ("8K", True): {
        PilotPattern.PP1: (6296, 4608, 3264), PilotPattern.PP2: (6298, 5760, 5312),
        PilotPattern.PP3: (6584, 5760, 3978), PilotPattern.PP4: (6588, 6336, 5742),
        PilotPattern.PP5: (6728, 6336, 4416), PilotPattern.PP6: _Z,
        PilotPattern.PP7: (6788, 6624, 5664), PilotPattern.PP8: (6788, 0, 0),
    },
    ("16K", False): {
        PilotPattern.PP1: (12418, 9088, 6437), PilotPattern.PP2: (12436, 11360, 10476),
        PilotPattern.PP3: (12988, 11360, 7845), PilotPattern.PP4: (13002, 12496, 11324),
        PilotPattern.PP5: (13272, 12496, 8709), PilotPattern.PP6: (13288, 13064, 11801),
        PilotPattern.PP7: (13416, 13064, 11170), PilotPattern.PP8: (13406, 0, 0),
    },
    ("16K", True): {
        PilotPattern.PP1: (12678, 9280, 6573), PilotPattern.PP2: (12698, 11600, 10697),
        PilotPattern.PP3: (13262, 11600, 8011), PilotPattern.PP4: (13276, 12760, 11563),
        PilotPattern.PP5: (13552, 12760, 8893), PilotPattern.PP6: (13568, 13340, 12051),
        PilotPattern.PP7: (13698, 13340, 11406), PilotPattern.PP8: (13688, 0, 0),
    },
    ("32K", False): {
        PilotPattern.PP1: _Z, PilotPattern.PP2: (24886, 22720, 20952),
        PilotPattern.PP3: _Z, PilotPattern.PP4: (26022, 24992, 22649),
        PilotPattern.PP5: _Z, PilotPattern.PP6: (26592, 26128, 23603),
        PilotPattern.PP7: (26836, 0, 0), PilotPattern.PP8: (26812, 0, 0),
    },
    ("32K", True): {
        PilotPattern.PP1: _Z, PilotPattern.PP2: (25412, 23200, 21395),
        PilotPattern.PP3: _Z, PilotPattern.PP4: (26572, 25520, 23127),
        PilotPattern.PP5: _Z, PilotPattern.PP6: (27152, 26680, 24102),
        PilotPattern.PP7: (27404, 0, 0), PilotPattern.PP8: (27376, 0, 0),
    },
}

# TR-PAPR reserved-tone count per fft key (subtracted from C_DATA/N_FC/C_FC
# when TR reservation is on; reference e.g. lib/framemapperfint_cc_impl.cc:469-479)
_TR_TONES = {"1K": 10, "2K": 18, "4K": 36, "8K": 72, "16K": 144, "32K": 288}

# scattered pilot lattice and amplitude per pattern
# reference lib/pilotgenp1insert_cc_impl.cc:927-992
_SP = {
    PilotPattern.PP1: (3, 4, 4.0 / 3.0),
    PilotPattern.PP2: (6, 2, 4.0 / 3.0),
    PilotPattern.PP3: (6, 4, 7.0 / 4.0),
    PilotPattern.PP4: (12, 2, 7.0 / 4.0),
    PilotPattern.PP5: (12, 4, 7.0 / 3.0),
    PilotPattern.PP6: (24, 2, 7.0 / 3.0),
    PilotPattern.PP7: (24, 4, 7.0 / 3.0),
    PilotPattern.PP8: (6, 16, 7.0 / 3.0),
}

# continual pilot amplitude per fft key
# reference lib/pilotgenp1insert_cc_impl.cc:748-925
_CP_AMP = {"1K": 4.0 / 3.0, "2K": 4.0 / 3.0, "4K": 4.0 * math.sqrt(2.0) / 3.0,
           "8K": 8.0 / 3.0, "16K": 8.0 / 3.0, "32K": 8.0 / 3.0}

_GI_FRACTION = {
    GuardInterval.GI_1_32: (1, 32),
    GuardInterval.GI_1_16: (1, 16),
    GuardInterval.GI_1_8: (1, 8),
    GuardInterval.GI_1_4: (1, 4),
    GuardInterval.GI_1_128: (1, 128),
    GuardInterval.GI_19_128: (19, 128),
    GuardInterval.GI_19_256: (19, 256),
}

# sample rates per bandwidth profile (Hz)
# reference lib/pilotgenp1insert_cc_impl.cc:1179-1201
_SAMPLE_RATE = {
    Bandwidth.BW_1_7_MHZ: 131.0e6 / 71.0,
    Bandwidth.BW_5_0_MHZ: 5.0 * 8.0e6 / 7.0,
    Bandwidth.BW_6_0_MHZ: 6.0 * 8.0e6 / 7.0,
    Bandwidth.BW_7_0_MHZ: 7.0 * 8.0e6 / 7.0,
    Bandwidth.BW_8_0_MHZ: 8.0 * 8.0e6 / 7.0,
    Bandwidth.BW_10_0_MHZ: 10.0 * 8.0e6 / 7.0,
}

# frame-closing symbol suppression in SISO mode
# reference lib/framemapperfint_cc_impl.cc:898-915
_FC_SUPPRESS = {
    (GuardInterval.GI_1_128, PilotPattern.PP7),
    (GuardInterval.GI_1_32, PilotPattern.PP4),
    (GuardInterval.GI_1_16, PilotPattern.PP2),
    (GuardInterval.GI_19_256, PilotPattern.PP2),
}

# constellation rotation angles in degrees (EN 302 755 table 14)
_ROTATION_DEG = {
    Constellation.QPSK: 29.0,
    Constellation.QAM16: 16.8,
    Constellation.QAM64: 8.6,
    Constellation.QAM256: 3.576334375,
}


def _cfg_to_dict(obj) -> dict:
    """Dataclass -> JSON-able dict: enums serialized by NAME (stable and
    human-auditable; the integer values already mirror the reference's
    public enums), nested PLPConfig tuples as lists of dicts."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name == "plps":
            out[f.name] = [_cfg_to_dict(p) for p in v]
        elif isinstance(v, IntEnum):
            out[f.name] = v.name
        else:
            out[f.name] = v
    return out


def _enum_fields(cls) -> dict:
    """Field name -> IntEnum subclass, resolved from the dataclass TYPE
    ANNOTATIONS (not the defaults: an enum-typed field declared with a
    non-enum default would otherwise let a JSON string pass through
    unconverted and fail far from the loader)."""
    cached = cls.__dict__.get("_enum_fields_cache")
    if cached is None:
        import typing
        hints = typing.get_type_hints(cls)
        cached = {n: t for n, t in hints.items()
                  if isinstance(t, type) and issubclass(t, IntEnum)}
        cls._enum_fields_cache = cached
    return cached


def _cfg_from_dict(cls, d: dict):
    """Inverse of _cfg_to_dict.  Enum fields accept the NAME string or the
    raw integer value; unknown keys are rejected (the reference's GRC XML
    layer silently drops unknown parameters - a config typo here must be
    loud, not a silently-default transmit chain)."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - set(fields))
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {unknown}")
    enum_by_name = _enum_fields(cls)
    kw = {}
    for name, v in d.items():
        if name == "plps":
            v = tuple(_cfg_from_dict(PLPConfig, p) for p in v)
        elif name in enum_by_name:
            enum_cls = enum_by_name[name]
            try:
                v = enum_cls[v] if isinstance(v, str) else enum_cls(v)
            except (KeyError, ValueError):
                raise ValueError(
                    f"{cls.__name__}.{name}: {v!r} is not a valid "
                    f"{enum_cls.__name__} (choices: "
                    f"{[m.name for m in enum_cls]})") from None
        kw[name] = v
    return cls(**kw)


@dataclass(frozen=True)
class PLPConfig:
    """Per-PLP parameters for a multi-PLP T2 frame (EN 302 755 section 8.3).

    The reference hardcodes a single PLP (lib/framemapperfint_cc_impl.cc:153
    ``num_plp = 1``); the framework generalizes to type-1 data PLPs with
    mixed code rates / constellations, each with its own FEC chain and time
    interleaver, mapped into the frame in plp_id order.
    """

    plp_id: int = 0
    code_rate: CodeRate = CodeRate.C4_5
    constellation: Constellation = Constellation.QAM256
    rotation: Rotation = Rotation.ON
    frame_size: FrameSize = FrameSize.SHORT
    fec_blocks: int = 8
    ti_blocks: int = 3
    plp_group_id: int = 1
    # EN 302 755 section 8.3.1: 0 = common PLP (carried once per frame,
    # placed before the data PLPs), 1 = type-1 data PLP (one contiguous
    # slice), 2 = type-2 data PLP (split into T2Config.sub_slices
    # sub-slices interleaved with the other type-2 PLPs)
    plp_type: int = 1

    def to_dict(self) -> dict:
        return _cfg_to_dict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PLPConfig":
        return _cfg_from_dict(cls, d)


@dataclass(frozen=True)
class T2Config:
    """Complete configuration of one DVB-T2 transmit chain."""

    frame_size: FrameSize = FrameSize.SHORT
    code_rate: CodeRate = CodeRate.C4_5
    constellation: Constellation = Constellation.QAM256
    rotation: Rotation = Rotation.ON
    fft_size: FFTSize = FFTSize.FFT_4K
    guard_interval: GuardInterval = GuardInterval.GI_1_32
    pilot_pattern: PilotPattern = PilotPattern.PP7
    carrier_mode: CarrierMode = CarrierMode.NORMAL
    preamble: Preamble = Preamble.T2_SISO
    miso_group: MisoGroup = MisoGroup.TX1
    papr: PAPR = PAPR.OFF
    version: Version = Version.V111
    l1_constellation: L1Constellation = L1Constellation.QAM64
    l1_scrambled: bool = False
    reserved_bias_bits: bool = False
    fec_blocks: int = 8          # FEC blocks per T2 frame (per interleaving frame)
    ti_blocks: int = 3           # time-interleaver blocks per T2 frame
    t2_frames: int = 2           # T2 frames per superframe
    num_data_symbols: int = 3    # L_data (includes the frame-closing symbol)
    input_mode: InputMode = InputMode.NORMAL
    in_band: InBand = InBand.OFF
    ts_rate: int = 4_000_000
    bandwidth: Bandwidth = Bandwidth.BW_1_7_MHZ
    equalization: bool = False
    # L1-post identity fields (reference hardcodes these,
    # lib/framemapperfint_cc_impl.cc:129-130,157)
    network_id: int = 0x3085
    t2_system_id: int = 0x8001
    frequency: int = 729_833_333
    # multi-PLP: empty tuple = single PLP defined by the top-level fields
    plps: tuple = ()
    # sub-slices per frame for the type-2 PLPs (EN 302 755 section
    # 8.3.6.3; L1 SUB_SLICES_PER_FRAME).  1 = type-2 PLPs are contiguous
    # like type 1.
    sub_slices: int = 1
    # FEF parts (EN 302 755 section 8.4): a FEF part of fef_length samples
    # follows every fef_interval-th T2 frame when fef_length > 0
    fef_length: int = 0
    fef_type: int = 0
    fef_interval: int = 1

    # ------------------------------------------------------- serialization
    # The declarative-config role of the reference's GRC XML layer
    # (grc/dvbt2ll_*.xml maps GUI parameters onto four separate block
    # constructors): ONE JSON document describes the whole chain and
    # round-trips losslessly; apps accept it via --config.

    def to_dict(self) -> dict:
        return _cfg_to_dict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "T2Config":
        return _cfg_from_dict(cls, d)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "T2Config":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_json_file(cls, path: str) -> "T2Config":
        """Load AND validate a chain config from a JSON file (the apps'
        --config entry point)."""
        with open(path) as fh:
            return cls.from_json(fh.read()).validate()

    # ------------------------------------------------------------------ FEC
    @cached_property
    def fec(self):
        table = _FEC_NORMAL if self.frame_size == FrameSize.NORMAL else _FEC_SHORT
        if self.code_rate not in table:
            raise ValueError(
                f"code rate {self.code_rate!r} invalid for {self.frame_size!r}")
        return table[self.code_rate]

    @property
    def kbch(self) -> int:
        return self.fec[0]

    @property
    def nbch(self) -> int:
        """BCH codeword length == LDPC information length (k_ldpc)."""
        return self.fec[1]

    @property
    def q_ldpc(self) -> int:
        return self.fec[2]

    @property
    def bch_t(self) -> int:
        return self.fec[3]

    @property
    def bch_parity_bits(self) -> int:
        return self.nbch - self.kbch

    @property
    def ldpc_frame_bits(self) -> int:
        return (FRAME_SIZE_NORMAL if self.frame_size == FrameSize.NORMAL
                else FRAME_SIZE_SHORT)

    @property
    def ldpc_parity_bits(self) -> int:
        return self.ldpc_frame_bits - self.nbch

    @property
    def df_bytes(self) -> int:
        """Data-field payload bytes per BB frame (input mode NORMAL)."""
        return (self.kbch - 80) // 8

    # ----------------------------------------------------------------- cells
    @property
    def mod_bits(self) -> int:
        return _MOD_BITS[self.constellation]

    @property
    def cell_size(self) -> int:
        return _CELLS[(self.frame_size, self.constellation)]

    @property
    def stream_cells(self) -> int:
        """Payload cells per T2 frame (this config's own PLP)."""
        return self.cell_size * self.fec_blocks

    # ------------------------------------------------------------- multi-PLP
    @property
    def num_plp(self) -> int:
        return max(1, len(self.plps))

    @cached_property
    def plp_configs(self) -> tuple:
        """Effective chain config per PLP: clones of this config with the
        PLP's FEC/mapping fields (a single-PLP config is its own entry)."""
        if not self.plps:
            return (self,)
        return tuple(
            dataclasses.replace(
                self, plps=(), code_rate=p.code_rate,
                constellation=p.constellation, rotation=p.rotation,
                frame_size=p.frame_size, fec_blocks=p.fec_blocks,
                ti_blocks=p.ti_blocks)
            for p in self.plps)

    @property
    def total_stream_cells(self) -> int:
        """Payload cells per T2 frame summed over all PLPs."""
        return sum(c.stream_cells for c in self.plp_configs)

    @property
    def plp_starts(self) -> tuple:
        """Cell offset of each PLP's slice within the PLP-major payload
        stream (the mapper-output order, before frame placement)."""
        starts, pos = [], 0
        for c in self.plp_configs:
            starts.append(pos)
            pos += c.stream_cells
        return tuple(starts)

    @property
    def plp_types(self) -> tuple:
        """PLP_TYPE per PLP (EN 302 755 section 8.3.1); a single-PLP
        config is one type-1 data PLP like the reference."""
        return (tuple(p.plp_type for p in self.plps) if self.plps
                else (1,))

    @property
    def type_2_start(self) -> int:
        """Payload-cell address of the first type-2 sub-slice (L1
        TYPE_2_START); 0 when the frame has no type-2 PLPs, matching the
        reference's constant (lib/framemapperfint_cc_impl.cc:248)."""
        if 2 not in self.plp_types:
            return 0
        return sum(c.stream_cells
                   for c, t in zip(self.plp_configs, self.plp_types)
                   if t != 2)

    @property
    def sub_slice_interval(self) -> int:
        """Cells from the start of one sub-slice of a type-2 PLP to the
        start of its next (L1 SUB_SLICE_INTERVAL, EN 302 755 section
        8.3.6.3.2): the total type-2 cells of one sub-slice group."""
        if 2 not in self.plp_types:
            return 0
        total2 = sum(c.stream_cells
                     for c, t in zip(self.plp_configs, self.plp_types)
                     if t == 2)
        return total2 // self.sub_slices

    @property
    def plp_frame_starts(self) -> tuple:
        """Frame-payload start address of each PLP (L1 PLP_START): common
        and type-1 PLPs are contiguous in config order; a type-2 PLP's
        address is that of its FIRST sub-slice (EN 302 755 section
        7.2.3.9).  Equals plp_starts when no PLP is type 2."""
        types = self.plp_types
        if 2 not in types:
            return self.plp_starts
        starts = []
        pos01 = 0
        pos2 = self.type_2_start
        for c, t in zip(self.plp_configs, types):
            if t != 2:
                starts.append(pos01)
                pos01 += c.stream_cells
            else:
                starts.append(pos2)
                pos2 += c.stream_cells // self.sub_slices
        return tuple(starts)

    @property
    def has_fef(self) -> bool:
        return self.fef_length > 0

    @property
    def rotation_angle_deg(self) -> float:
        return _ROTATION_DEG[self.constellation] if self.rotation else 0.0

    # ------------------------------------------------------------------ OFDM
    @property
    def fft_key(self) -> str:
        return _FFT_KEY[self.fft_size]

    @property
    def fft_points(self) -> int:
        return _FFT_POINTS[self.fft_key]

    @property
    def miso(self) -> bool:
        return self.preamble in (Preamble.T2_MISO, Preamble.T2_LITE_MISO)

    @property
    def n_p2(self) -> int:
        return _P2[self.fft_key][0]

    @property
    def c_p2(self) -> int:
        return _P2[self.fft_key][2 if self.miso else 1]

    @cached_property
    def carriers(self):
        """(C_PS, K_EXT, K_OFFSET)."""
        modes = _CARRIERS[self.fft_key]
        if self.carrier_mode not in modes:
            raise ValueError(
                f"extended carriers unsupported for {self.fft_key} FFT")
        return modes[self.carrier_mode]

    @property
    def c_ps(self) -> int:
        return self.carriers[0]

    @property
    def k_ext(self) -> int:
        return self.carriers[1]

    @property
    def k_offset(self) -> int:
        return self.carriers[2]

    @cached_property
    def symbol_cells(self):
        """(C_DATA, N_FC, C_FC) after PAPR adjustment and FC suppression."""
        extended = self.carrier_mode == CarrierMode.EXTENDED
        c_data, n_fc, c_fc = _CDATA[(self.fft_key, extended)][self.pilot_pattern]
        if c_data == 0:
            raise ValueError(
                f"pilot pattern {self.pilot_pattern!r} invalid for "
                f"{self.fft_key} FFT")
        if self.papr in (PAPR.TR, PAPR.BOTH):
            tr = _TR_TONES[self.fft_key]
            c_data -= tr
            n_fc = max(0, n_fc - tr)
            c_fc = max(0, c_fc - tr)
        if not self.miso and (self.guard_interval, self.pilot_pattern) in _FC_SUPPRESS:
            n_fc = 0
            c_fc = 0
        return c_data, n_fc, c_fc

    @property
    def c_data(self) -> int:
        return self.symbol_cells[0]

    @property
    def n_fc(self) -> int:
        return self.symbol_cells[1]

    @property
    def c_fc(self) -> int:
        return self.symbol_cells[2]

    @property
    def has_fc_symbol(self) -> bool:
        return self.n_fc != 0

    @property
    def num_plain_data_symbols(self) -> int:
        """Data symbols excluding the frame-closing symbol."""
        return self.num_data_symbols - (1 if self.has_fc_symbol else 0)

    @property
    def num_symbols(self) -> int:
        """Total OFDM symbols per T2 frame (P2 + data + FC)."""
        return self.n_p2 + self.num_data_symbols

    @property
    def mapped_cells(self) -> int:
        """Active cells per T2 frame (frame-mapper output).

        reference lib/framemapperfint_cc_impl.cc:1133-1161
        """
        if self.has_fc_symbol:
            return (self.n_p2 * self.c_p2
                    + self.num_plain_data_symbols * self.c_data + self.n_fc)
        return self.n_p2 * self.c_p2 + self.num_data_symbols * self.c_data

    @property
    def sp_dx(self) -> int:
        return _SP[self.pilot_pattern][0]

    @property
    def sp_dy(self) -> int:
        return _SP[self.pilot_pattern][1]

    @property
    def sp_amplitude(self) -> float:
        return _SP[self.pilot_pattern][2]

    @property
    def cp_amplitude(self) -> float:
        return _CP_AMP[self.fft_key]

    @property
    def p2_amplitude(self) -> float:
        if self.fft_key == "32K" and not self.miso:
            return math.sqrt(37.0) / 5.0
        return math.sqrt(31.0) / 5.0

    @property
    def guard_samples(self) -> int:
        num, den = _GI_FRACTION[self.guard_interval]
        return (self.fft_points * num) // den

    @property
    def ofdm_normalization(self) -> float:
        return 5.0 / math.sqrt(27.0 * self.c_ps)

    @property
    def samples_per_frame(self) -> int:
        """Baseband IQ samples per T2 frame, including the P1 preamble."""
        return self.num_symbols * (self.fft_points + self.guard_samples) + 2048

    @property
    def sample_rate(self) -> float:
        return _SAMPLE_RATE[self.bandwidth]

    @property
    def frame_duration(self) -> float:
        """T2 frame duration in seconds at the profile sample rate."""
        return self.samples_per_frame / self.sample_rate

    @property
    def emitted_frame_duration(self) -> float:
        """Average per-T2-frame airtime of the EMITTED stream, including
        the amortized FEF part after every fef_interval-th frame (exact
        over a superframe: validate() makes fef_interval divide
        t2_frames).  This is the pacing unit for real-time emission."""
        extra = (self.fef_length / self.fef_interval / self.sample_rate
                 if self.has_fef else 0.0)
        return self.frame_duration + extra

    # -------------------------------------------------------------------- L1
    @property
    def eta_mod(self) -> int:
        return {L1Constellation.BPSK: 1, L1Constellation.QPSK: 2,
                L1Constellation.QAM16: 4, L1Constellation.QAM64: 6}[
                    self.l1_constellation]

    @property
    def ksig_post(self) -> int:
        """L1-post signalling bits incl. CRC-32: 318 for one PLP (matching
        the reference's fixed KSIG_POST=350 minus nothing), plus 137 bits
        (89 configurable + 48 dynamic) per additional PLP, plus 34 FEF
        fields when S2 signals mixed frames."""
        return (318 + (self.num_plp - 1) * 137
                + (34 if self.has_fef else 0) + 32)

    @cached_property
    def l1post_sizes(self):
        """(N_post, N_punc); reference lib/framemapperfint_cc_impl.cc:978-987."""
        n_punc_temp = (6 * (KBCH_1_2 - self.ksig_post)) // 5
        n_post_temp = self.ksig_post + NBCH_PARITY + 9000 - n_punc_temp
        eta = self.eta_mod
        if self.n_p2 == 1:
            n_post = math.ceil(n_post_temp / (2 * eta)) * 2 * eta
        else:
            n_post = math.ceil(n_post_temp / (eta * self.n_p2)) * eta * self.n_p2
        return n_post, n_punc_temp - (n_post - n_post_temp)

    @property
    def n_post(self) -> int:
        return self.l1post_sizes[0]

    @property
    def n_punc(self) -> int:
        return self.l1post_sizes[1]

    @property
    def l1post_cells(self) -> int:
        return self.n_post // self.eta_mod

    @property
    def dummy_cells(self) -> int:
        n = (self.mapped_cells - self.total_stream_cells - N_L1PRE_CELLS
             - self.l1post_cells - (self.n_fc - self.c_fc))
        if n < 0:
            raise ValueError(
                f"too many FEC blocks per T2 frame: need {-n} more cells")
        return n

    # -------------------------------------------------------- time interleaver
    @cached_property
    def ti_structure(self):
        """(fec_per_small, fec_per_big, num_small, num_big).

        reference lib/framemapperfint_cc_impl.cc:1108-1119
        """
        if self.ti_blocks == 0:
            return 1, 1, self.fec_blocks, 0
        small = self.fec_blocks // self.ti_blocks
        big = math.ceil(self.fec_blocks / self.ti_blocks)
        n_big = self.fec_blocks % self.ti_blocks
        return small, big, self.ti_blocks - n_big, n_big

    def validate(self) -> "T2Config":
        """Raise ValueError for inconsistent parameter combinations.

        Beyond arithmetic consistency this enforces the version/preamble
        gating the reference encodes only in its GRC UI layer
        (grc/dvbt2ll_framemapperfint_cc.xml:7-29 and the param ``hide``
        attributes): T2-Lite preambles exist only in the V1.3.1 option
        set, the FFT-size menu differs between base (no 16K-T2GI) and
        lite (no 1K/32K) profiles, and L1-post scrambling / reserved-bias
        bits are V1.3.1-only fields (previously silently ignored
        off-version by tables/l1.py).  HIEFF input mode and in-band
        signalling are NOT version-gated: the block-level UI
        (grc/dvbt2ll_bbheaderbch_bb.xml:7) accepts them at any version
        and the reference binary emits them under V1.1.1 (pinned by the
        hieff_4k/inband_2k reference goldens).  PAPR needs no gate: the
        V1.1.1 and V1.3.1 menus carry identical values (only the
        PAPR_OFF label changes to "P2 Only").  T2-Lite FEC restrictions
        (16200-bit frames only, no rates 4/5 or 5/6) follow EN 302 755
        V1.3.1 Annex I — stricter than the reference, which leaves them
        to the user.
        """
        _ = self.fec, self.carriers, self.symbol_cells, self.dummy_cells
        if self.preamble == Preamble.NON_T2:
            raise ValueError(
                "preamble NON_T2 labels FEF parts, not T2 frames; a "
                "transmitter config must use a T2 or T2-Lite preamble "
                "(FEF parts are configured via fef_length/fef_type)")
        lite = self.preamble in (Preamble.T2_LITE_SISO,
                                 Preamble.T2_LITE_MISO)
        if lite:
            if self.version != Version.V131:
                raise ValueError(
                    "T2-Lite preambles require version=Version.V131 (the "
                    "reference offers lite preambles only in its 1.3.1 "
                    "option set, grc/dvbt2ll_framemapperfint_cc.xml)")
            if self.fft_size in (FFTSize.FFT_1K, FFTSize.FFT_32K,
                                 FFTSize.FFT_32K_T2GI):
                raise ValueError(
                    f"{self.fft_size!r} is not available in the T2-Lite "
                    "profile (lite FFT menu: 2K/4K/8K/16K incl. T2GI "
                    "variants)")
            if self.frame_size != FrameSize.SHORT:
                raise ValueError(
                    "T2-Lite uses only 16200-bit (short) FEC frames "
                    "(EN 302 755 V1.3.1 Annex I)")
            if self.code_rate in (CodeRate.C4_5, CodeRate.C5_6):
                raise ValueError(
                    f"code rate {self.code_rate!r} is not part of the "
                    "T2-Lite profile (EN 302 755 V1.3.1 Annex I)")
        elif self.fft_size == FFTSize.FFT_16K_T2GI:
            raise ValueError(
                "FFT_16K_T2GI exists only in the T2-Lite profile; the "
                "base-profile menu offers FFT_16K")
        if self.l1_scrambled and self.version != Version.V131:
            raise ValueError(
                "l1_scrambled is a V1.3.1-only L1 feature; use "
                "version=Version.V131 (the reference UI hides it "
                "otherwise and earlier receivers would not descramble)")
        if self.reserved_bias_bits and self.version != Version.V131:
            raise ValueError(
                "reserved_bias_bits is a V1.3.1-only L1 feature; use "
                "version=Version.V131")
        if self.num_plain_data_symbols < 0:
            raise ValueError("num_data_symbols must be >= 1")
        if self.t2_frames < 1 or self.t2_frames > 255:
            raise ValueError("t2_frames must be in 1..255")
        if self.fec_blocks < 1:
            raise ValueError("fec_blocks must be >= 1")
        if self.ti_blocks > self.fec_blocks:
            raise ValueError("ti_blocks must be <= fec_blocks")
        if self.plps:
            ids = [p.plp_id for p in self.plps]
            if len(set(ids)) != len(ids):
                raise ValueError("plp_id values must be unique")
            for c in self.plp_configs:
                _ = c.fec
                if c.ti_blocks > c.fec_blocks:
                    raise ValueError("ti_blocks must be <= fec_blocks per PLP")
            types = [p.plp_type for p in self.plps]
            if any(t not in (0, 1, 2) for t in types):
                raise ValueError("plp_type must be 0 (common), 1 or 2")
            if types != sorted(types):
                raise ValueError(
                    "PLPs must be ordered common (type 0), then type 1, "
                    "then type 2 - the T2 frame carries them in that "
                    "order (EN 302 755 section 8.3.6)")
            if types and set(types) == {0}:
                raise ValueError(
                    "a frame of only common PLPs is invalid: each common "
                    "PLP serves a group of data PLPs (EN 302 755 "
                    "section 8.3.1)")
        if self.sub_slices < 1 or self.sub_slices >= 1 << 15:
            raise ValueError("sub_slices must be in 1..32767 (15-bit "
                             "L1 SUB_SLICES_PER_FRAME)")
        if self.sub_slices > 1:
            types = self.plp_types
            if 2 not in types:
                raise ValueError(
                    "sub_slices > 1 requires at least one type-2 PLP "
                    "(PLPConfig.plp_type=2)")
            for c, t in zip(self.plp_configs, types):
                if t == 2 and c.stream_cells % self.sub_slices:
                    raise ValueError(
                        f"type-2 PLP payload ({c.stream_cells} cells) "
                        f"must divide into {self.sub_slices} equal "
                        f"sub-slices")
        if self.ksig_post > KBCH_1_2:
            raise ValueError("too many PLPs for the L1-post capacity")
        if self.has_fef:
            if self.fef_length < 2048:
                raise ValueError("fef_length must cover at least the FEF P1")
            if self.fef_length >= 1 << 24:
                raise ValueError("fef_length exceeds 24-bit L1 field")
            # the 2 MSBs ride in FEF_LENGTH_MSB, a V1.3.1-only L1-post
            # field (tables/l1.py); earlier versions can signal 22 bits
            if self.version != Version.V131 and self.fef_length >= 1 << 22:
                raise ValueError(
                    "fef_length needs the FEF_LENGTH_MSB bits, which only "
                    "T2 version 1.3.1 signals; use version=Version.V131 "
                    "or fef_length < 2**22")
            if not 1 <= self.fef_interval <= 255:
                raise ValueError("fef_interval must be in 1..255")
            if self.t2_frames % self.fef_interval:
                raise ValueError(
                    "fef_interval must divide t2_frames (whole FEF parts "
                    "per super-frame)")
        if self.num_symbols > PN_CHIPS:
            # the port's own rule, checked last so that every config the
            # JAX package refuses is refused with its message; the JAX
            # package accepts these and its planner then indexes past the
            # PN sequence (dvbt2ll_tpu/tables/pilots.py:212)
            raise ValueError(
                f"{self.num_symbols} OFDM symbols a T2 frame (P2 and data) "
                f"exceed the {PN_CHIPS} chips of the frame's PN sequence, "
                f"one chip a symbol (EN 302 755 table 35)")
        return self


def vv009_config() -> T2Config:
    """The reference example flowgraph configuration (apps/vv009-4kshort.grc)."""
    return T2Config().validate()


NAMED_CONFIGS = (
    "vv009_4kshort", "8k_normal", "32k_extended", "hieff_4k", "inband_2k",
    "8k_miso_tx1", "8k_miso_tx2", "16k_l1qpsk_both", "1k_pp4",
    "qpsk_short_c13", "ti_off_4k", "t2lite_4k", "t2lite_8k_t2gi_miso",
    "t2lite_16k_t2gi", "v121_4k", "multiplp_fef", "eq_2k_5mhz",
    "32k_papr_tr", "uk_t2_32k")


def named_config(name: str) -> T2Config:
    """The registry of ``bench.py:_named_config``, name for name and value
    for value.  The BASELINE.json matrix (vv009_4kshort, 8k_normal,
    32k_extended, multiplp_fef) plus one config per reference work-loop
    branch with a reference-binary golden in ``tests/golden_ref``; see
    ``bench.py`` for what each one pins.  ``uk_t2_32k``, the port's own,
    is not in ``bench.py``: the UK DVB-T2 HD multiplex (Freeview HD), from
    EBU Tech 3348 (Frequency and Network Planning Aspects of DVB-T2) and
    ETSI TS 102 831 (DVB-T2 implementation guidelines): 8 MHz, 32K
    extended carriers, GI 1/128, PP7, 256QAM rotated, CR 2/3, 64800-bit
    LDPC, one PLP.  Assumed, as the sources leave them open: 59 data
    symbols (with P2, 60 symbols, 216.944 ms a frame, under 250 ms); 202
    FEC blocks, the most such a frame holds (978 dummy cells); NORMAL
    input mode, 40.0 Mbit/s of TS (the published 40.2 Mbit/s is that
    times 188/187, High Efficiency Mode's rate); 3 TI blocks of 67, 67
    and 68 FEC blocks (68 x 8100 cells fit the 2^19 + 2^15 of one PLP's
    TI memory, 2 blocks would not); 2 T2 frames a superframe; every other
    field the default."""
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
    if name == "uk_t2_32k":
        return T2Config(
            frame_size=FrameSize.NORMAL, code_rate=CodeRate.C2_3,
            constellation=Constellation.QAM256, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_32K, guard_interval=GuardInterval.GI_1_128,
            pilot_pattern=PilotPattern.PP7, carrier_mode=CarrierMode.EXTENDED,
            fec_blocks=202, ti_blocks=3, t2_frames=2, num_data_symbols=59,
            bandwidth=Bandwidth.BW_8_0_MHZ).validate()
    raise ValueError(f"unknown config {name!r}; known: {NAMED_CONFIGS}")
