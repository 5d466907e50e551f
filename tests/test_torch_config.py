"""The port's own configuration (``stratum_dsp_tpu_torch/config.py``) against
the JAX package's (``stratum_dsp_tpu/config.py``): the same fields in the same
order with the same defaults, the same enums, and ``from_dict`` as the one way
a JAX-side config crosses over to the port.
"""

import dataclasses
import enum

import pytest

from stratum_dsp_tpu import config as jcfg
from stratum_dsp_tpu_torch import config as pcfg

JAX_FIELDS = dataclasses.fields(jcfg.AnalysisConfig)
PORT_FIELDS = dataclasses.fields(pcfg.AnalysisConfig)
# the comment headings of the config: preprocessing, onsets, BPM, STFT and
# the grid extensions, key
FIELD_GROUPS = {
    "preprocessing": ("min_amplitude_db", "enable_silence_trimming"),
    "onsets": ("enable_onset_consensus", "hpss_margin"),
    "bpm": ("force_legacy_bpm", "bpm_resolution"),
    "stft-and-grid": ("frame_size", "beat_contrast_fractional"),
    "key": ("center_frequency", "key_minor_leading_tone_bonus_weight"),
}
# the variant configs of tests/test_torch_slice.py, and the slice itself
VARIANTS = {
    "default": {},
    "slice": dict(enable_tempogram_multi_resolution=False),
    "grid-reference-conventions": dict(enable_beat_phase_search=False,
                                       enable_beat_grid_fill=False,
                                       enable_downbeat_phase_search=False),
    "full-band-no-consensus": dict(enable_tempogram_band_fusion=False,
                                   enable_tempogram_mel_novelty=False,
                                   enable_onset_consensus=False),
    "key-unweighted-sharpened": dict(enable_key_segment_voting=False,
                                     enable_key_frame_weighting=False,
                                     chroma_sharpening_power=2.0, enable_normalization=False),
    "untrimmed-temperley": dict(enable_silence_trimming=False,
                                enable_legacy_bpm_guardrails=False,
                                key_template_set=jcfg.TemplateSet.TEMPERLEY),
    "rms-lists": dict(normalization=jcfg.NormalizationMethod.RMS,
                      key_multi_scale_weights=[0.5, 0.3, 0.2],
                      onset_consensus_weights=[0.4, 0.3, 0.2, 0.1]),
}


def _plain(value):
    """A field value with enum members reduced to (name, value)."""
    return (value.name, value.value) if isinstance(value, enum.Enum) else value


def _group(fields, first, last):
    names = [f.name for f in fields]
    return fields[names.index(first):names.index(last) + 1]


def test_groups_cover_every_field():
    names = [f.name for f in JAX_FIELDS]
    covered = [f.name for first, last in FIELD_GROUPS.values()
               for f in _group(JAX_FIELDS, first, last)]
    assert covered == names


@pytest.mark.parametrize("group", FIELD_GROUPS)
def test_fields_match_jax(group):
    """Names, order, annotations and defaults, field group by field group."""
    first, last = FIELD_GROUPS[group]
    ref, got = _group(JAX_FIELDS, first, last), _group(PORT_FIELDS, first, last)
    assert [f.name for f in got] == [f.name for f in ref]
    for j, p in zip(ref, got):
        assert p.type == j.type, p.name
        assert _plain(p.default) == _plain(j.default), p.name
        assert type(p.default) is type(j.default) or isinstance(j.default, enum.Enum), p.name


def test_field_count_and_order_match_jax():
    assert [f.name for f in PORT_FIELDS] == [f.name for f in JAX_FIELDS]


@pytest.mark.parametrize("name", ["NormalizationMethod", "TemplateSet"])
def test_enums_match_jax(name):
    ref, got = getattr(jcfg, name), getattr(pcfg, name)
    assert got is not ref
    assert [(m.name, m.value) for m in got] == [(m.name, m.value) for m in ref]


@pytest.mark.parametrize("variant", VARIANTS)
def test_from_dict_round_trips(variant):
    """asdict of the JAX config -> the port's config -> asdict: the same
    mapping, enum members matched by name and value."""
    jax_cfg = jcfg.AnalysisConfig(**VARIANTS[variant])
    mapping = dataclasses.asdict(jax_cfg)
    cfg = pcfg.AnalysisConfig.from_dict(mapping)
    assert type(cfg) is pcfg.AnalysisConfig
    back = dataclasses.asdict(cfg)
    assert list(back) == list(mapping)
    assert {k: _plain(v) for k, v in back.items()} == {k: _plain(v) for k, v in mapping.items()}
    assert isinstance(cfg.normalization, pcfg.NormalizationMethod)
    assert isinstance(cfg.key_template_set, pcfg.TemplateSet)
    # and through its own dict again
    assert pcfg.AnalysisConfig.from_dict(back) == cfg


@pytest.mark.parametrize("given", ["TEMPERLEY", "temperley", jcfg.TemplateSet.TEMPERLEY,
                                   pcfg.TemplateSet.TEMPERLEY],
                         ids=["name", "value", "jax-member", "port-member"])
def test_from_dict_takes_enums_by_name_value_or_member(given):
    cfg = pcfg.AnalysisConfig.from_dict({"key_template_set": given})
    assert cfg.key_template_set is pcfg.TemplateSet.TEMPERLEY
    assert cfg == pcfg.AnalysisConfig(key_template_set=pcfg.TemplateSet.TEMPERLEY)


@pytest.mark.parametrize("make", [lambda c: c.AnalysisConfig(no_such_field=1),
                                  lambda c: c.AnalysisConfig().replace(no_such_field=1),
                                  lambda c: c.TemplateSet("no_such_set"),
                                  lambda c: c.NormalizationMethod(3)],
                         ids=["unknown-field", "unknown-replace", "bad-template-set",
                              "bad-normalization"])
def test_bad_values_raise_as_in_jax(make):
    with pytest.raises((TypeError, ValueError)) as ref:
        make(jcfg)
    with pytest.raises(ref.type):
        make(pcfg)


def test_from_dict_refuses_unknown_keys_and_members():
    with pytest.raises(TypeError):
        pcfg.AnalysisConfig.from_dict({"no_such_field": 1})
    with pytest.raises(ValueError):
        pcfg.AnalysisConfig.from_dict({"normalization": "no_such_method"})


def test_config_is_frozen_and_hashable():
    """It keys the cache of the reducer's tables: equal configs hash equal,
    lists become tuples, and no field can be set."""
    a = pcfg.AnalysisConfig(onset_consensus_weights=[0.4, 0.3, 0.2, 0.1])
    b = pcfg.AnalysisConfig.from_dict(
        dataclasses.asdict(jcfg.AnalysisConfig(onset_consensus_weights=[0.4, 0.3, 0.2, 0.1])))
    assert a == b and hash(a) == hash(b) and len({a, b, pcfg.AnalysisConfig()}) == 2
    assert a.onset_consensus_weights == (0.4, 0.3, 0.2, 0.1)
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.hop_size = 256
    assert pcfg.DEFAULT_CONFIG == pcfg.AnalysisConfig()
