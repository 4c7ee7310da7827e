"""The port's ``config`` against the JAX package's: the seeded
``validate()`` sweep of tests/test_config.py (the same outcome and the
same message for every sample, and equal derived properties and plans for
every config both accept), the JSON/dict cases of tests/test_config.py on
the port's ``T2Config``, and the package's exports.

One rule is the port's own: ``validate()`` refuses a frame of more OFDM
symbols than the PN sequence has chips (2624).  The JAX package accepts
such a config and its planner then indexes past the sequence
(``dvbt2ll_tpu/tables/pilots.py:212``); the sweep holds four of them.
"""
import dataclasses
import random

import pytest

import dvbt2ll_tpu
import dvbt2ll_tpu_torch
from dvbt2ll_tpu import config as jax_config
from dvbt2ll_tpu.plan import build_plan as jax_build_plan
from dvbt2ll_tpu.tables.sequences import pn_sequence as jax_pn_sequence
from dvbt2ll_tpu_torch import config
from dvbt2ll_tpu_torch.config import (PN_CHIPS, CodeRate, Constellation,
                                      FFTSize, FrameSize, GuardInterval,
                                      InputMode, PilotPattern, PLPConfig,
                                      T2Config, vv009_config)
from dvbt2ll_tpu_torch.plan import build_plan, min_batch_frames
from dvbt2ll_tpu_torch.tables.sequences import pn_sequence
from tests.torch_compare import properties, same

_ENUMS = ("frame_size", "code_rate", "constellation", "rotation", "fft_size",
          "guard_interval", "pilot_pattern", "carrier_mode", "preamble",
          "miso_group", "papr", "version", "l1_constellation", "input_mode",
          "in_band", "bandwidth")


def _enum_class(mod, field: str):
    """The enum class of a ``T2Config`` field (annotations are strings)."""
    types = {f.name: f.type for f in dataclasses.fields(mod.T2Config)}
    return getattr(mod, types[field])


def _sweep() -> list:
    """The 300 samples of tests/test_config.py::
    test_validate_fuzz_never_leaks_internal_errors, drawn with its seed
    and in its order, as ``T2Config.from_dict`` keyword dicts (enums by
    name, so one dict builds either package's config)."""
    rng = random.Random(0)
    enums = {k: [m.name for m in _enum_class(jax_config, k)]
             for k in _ENUMS}
    out = []
    for _ in range(300):
        kw = {k: rng.choice(v) for k, v in enums.items()}
        kw.update(fec_blocks=rng.choice([0, 1, 2, 8, 200, 3000]),
                  ti_blocks=rng.choice([0, 1, 3, 10]),
                  t2_frames=rng.choice([1, 2, 8, 255, 256]),
                  num_data_symbols=rng.choice([0, 1, 3, 8, 100, 3000]),
                  l1_scrambled=rng.random() < 0.3,
                  reserved_bias_bits=rng.random() < 0.3,
                  fef_length=rng.choice([0, 4096]),
                  fef_interval=rng.choice([1, 2]),
                  sub_slices=rng.choice([1, 2]))
        out.append(kw)
    return out


def _outcome(mod, kw):
    """(config, None) when ``validate()`` accepts, else (None, the
    exception's type and text)."""
    try:
        return mod.T2Config.from_dict(kw).validate(), None
    except Exception as e:  # noqa: BLE001 - the type is compared too
        return None, (type(e).__name__, str(e))


_SAMPLES = _sweep()
_OUTCOMES = [(_outcome(config, kw), _outcome(jax_config, kw))
             for kw in _SAMPLES]
_BOTH_ACCEPT = [i for i, ((ours, _), (theirs, _)) in enumerate(_OUTCOMES)
                if ours is not None and theirs is not None]


def test_enums_are_the_jax_packages():
    """The sweep draws enum members by name from the JAX package's
    enums; the port's have the same members in the same order, with the
    same values."""
    for field in _ENUMS:
        ours = [(m.name, m.value) for m in _enum_class(config, field)]
        theirs = [(m.name, m.value) for m in _enum_class(jax_config, field)]
        assert ours == theirs, field


def test_validate_sweep_same_outcome_and_message():
    """Every sample: both accept, or both refuse with the same exception
    type and text; except the frames of more symbols than PN chips, which
    only the port refuses (its message names the rule), and whose JAX
    plan cannot be built."""
    assert len(_SAMPLES) == 300
    pn_only = []
    for i, ((ours, why_ours), (theirs, why_theirs)) in enumerate(_OUTCOMES):
        if ours is None and theirs is not None:
            assert why_ours[0] == "ValueError", (i, why_ours)
            assert f"the {PN_CHIPS} chips of the frame's PN" in why_ours[1]
            assert theirs.num_symbols > len(jax_pn_sequence()) == PN_CHIPS
            pn_only.append(i)
            continue
        assert (ours is None) == (theirs is None), (i, why_ours, why_theirs)
        assert why_ours == why_theirs, i
    assert len(pn_only) == 4
    assert len(_BOTH_ACCEPT) == 4     # as the JAX test says: a handful
    assert len(pn_sequence()) == PN_CHIPS


@pytest.mark.parametrize("i", _BOTH_ACCEPT)
def test_sweep_accepted_configs_plan_alike(i):
    """A config both packages accept: equal fields, equal derived
    properties, and equal plans of one frame (HIEFF: the smallest batch
    of whole packets)."""
    (ours, _), (theirs, _) = _OUTCOMES[i]
    same(ours, theirs, f"sample {i}")
    for p in properties(config.T2Config):
        same(getattr(ours, p), getattr(theirs, p), f"sample {i}.{p}")
    batch = (min_batch_frames(ours) if ours.input_mode == InputMode.HIEFF
             else 1)
    same(build_plan(ours, batch, strict=False),
         jax_build_plan(theirs, batch, strict=False), f"sample {i} plan")


def _multi_plp():
    return T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C4_5,
        constellation=Constellation.QAM256,
        fft_size=FFTSize.FFT_4K, guard_interval=GuardInterval.GI_1_32,
        pilot_pattern=PilotPattern.PP7, t2_frames=2, num_data_symbols=6,
        plps=(PLPConfig(plp_id=0, plp_type=0, fec_blocks=1, ti_blocks=1),
              PLPConfig(plp_id=1, fec_blocks=2, ti_blocks=1),
              PLPConfig(plp_id=2, fec_blocks=2, ti_blocks=1)),
        fef_length=4096, fef_interval=2).validate()


def test_config_json_round_trip():
    """tests/test_config.py::test_config_json_round_trip on the port:
    lossless, nested PLPs included; enums by name, raw ints load."""
    cfg = vv009_config()
    assert T2Config.from_json(cfg.to_json()) == cfg
    multi = _multi_plp()
    back = T2Config.from_json(multi.to_json())
    assert back == multi and back.plps[0].plp_type == 0
    d = cfg.to_dict()
    assert d["code_rate"] == "C4_5" and d["fft_size"] == "FFT_4K"
    d["code_rate"] = int(CodeRate.C4_5)
    assert T2Config.from_dict(d) == cfg


def test_unknown_keys_are_refused():
    with pytest.raises(ValueError, match="unknown T2Config fields"):
        T2Config.from_dict({"ffft_size": "FFT_4K"})
    with pytest.raises(ValueError, match="unknown PLPConfig fields"):
        PLPConfig.from_dict({"plp_idd": 0})


def test_enum_typo_raises_value_error():
    d = vv009_config().to_dict()
    d["code_rate"] = "C4_55"
    with pytest.raises(ValueError, match="T2Config.code_rate.*C4_55"):
        T2Config.from_dict(d)


@pytest.mark.parametrize("name", config.NAMED_CONFIGS)
def test_json_is_the_jax_packages(name):
    """A config's JSON document is the JAX package's, text for text, and
    each package loads the other's: one ``--config`` file serves both."""
    ours = config.named_config(name)
    theirs = jax_config.T2Config.from_json(ours.to_json())
    assert theirs.to_json() == ours.to_json()
    assert T2Config.from_json(theirs.to_json()) == ours


def test_exports_cover_the_jax_packages():
    """``dvbt2ll_tpu_torch`` exports every name ``dvbt2ll_tpu`` does
    (besides its own), and each is the port's object of that name."""
    assert set(dvbt2ll_tpu.__all__) <= set(dvbt2ll_tpu_torch.__all__)
    for name in dvbt2ll_tpu_torch.__all__:
        obj = getattr(dvbt2ll_tpu_torch, name)
        assert obj.__module__.startswith("dvbt2ll_tpu_torch"), name
    assert dvbt2ll_tpu_torch.PLPConfig is PLPConfig
    assert dvbt2ll_tpu_torch.InputMode is InputMode
