"""The port's host runtime (``stratum_dsp_tpu_torch``: ``result.py``,
``errors.py``, ``analysis/{decode,timing,debug,metadata}.py``,
``preprocessing/channel_mixer.py`` and the ``cand_*`` / ``dbg_*`` /
``debug_stop_after`` outputs of ``analysis/pipeline.py``) against the JAX
package, on the CPU.

The same batch (``tests/torch_port_reference.py``: samples as a 16-bit WAV
holds them) goes through both pipelines; ``decode_results`` of both dicts
must give equal ``AnalysisResult.to_dict()``: strings, flags,
``methods_used``, warnings and every discrete field exactly, BPM to 1e-2 and
the other floats to 1e-3 (the bounds of ``assert_outputs_match``, which the
raw dicts are held to first). The candidate table is compared row by row:
on these tracks the candidate order is the same on both sides.
"""

import dataclasses
import io
import logging
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import stratum_dsp_tpu as jpkg
import stratum_dsp_tpu.analysis as janalysis
from stratum_dsp_tpu.analysis import debug as jdebug
from stratum_dsp_tpu.analysis import decode_results as jax_decode_results
from stratum_dsp_tpu.analysis import timing as jtiming
from stratum_dsp_tpu.analysis.pipeline import PipelineCaps as JaxCaps
from stratum_dsp_tpu.analysis.pipeline import analyze_batch_arrays as jax_analyze_arrays
from stratum_dsp_tpu.preprocessing import channel_mixer as jmixer
import stratum_dsp_tpu_torch as port
import stratum_dsp_tpu_torch.analysis as panalysis
from stratum_dsp_tpu_torch.analysis import debug as pdebug
from stratum_dsp_tpu_torch.analysis import decode as pdecode
from stratum_dsp_tpu_torch.analysis import timing as ptiming
from stratum_dsp_tpu_torch.analysis.pipeline import STAGES
from stratum_dsp_tpu_torch.preprocessing import channel_mixer as pmixer
from stratum_dsp_tpu_torch.testing import FLOAT_TOL, assert_outputs_match

import torch_port_reference as reference

torch.set_num_threads(2)

SR = reference.SAMPLE_RATE
SMALL_CAPS = dict(max_onsets=256, max_beats=256, seg_beat_cap=32, max_segments=12)


@pytest.fixture(scope="module")
def jax_debug_out():
    return reference.jax_debug_output()


@pytest.fixture(scope="module")
def port_debug_out():
    samples, lengths = reference.batch()
    return port.analyze_batch(samples, lengths, reference.port_config(reference.jax_debug_config()),
                              SR, device="cpu")


def test_debug_outputs_match_jax(jax_debug_out, port_debug_out):
    """``cand_*`` and ``dbg_*`` beside every other output: discrete ones
    exactly, floats at the slice test's bounds, same keys, shapes, dtypes."""
    assert_outputs_match(jax_debug_out, port_debug_out)
    assert {k for k in jax_debug_out if k.startswith("dbg_")} == {
        "dbg_base_bpm", "dbg_base_conf", "dbg_base_agree", "dbg_s_base", "dbg_s_2x",
        "dbg_s_half", "dbg_trap_low", "dbg_trap_high", "dbg_family_competes", "dbg_weak_base",
        "dbg_fold_into_trap", "dbg_ambiguous"}
    used = jax_debug_out["multi_res_used"]
    assert used.any() and not used.all()
    # a track that escalated carries the escalation's table: its selected
    # candidate is the escalation's BPM, not the base estimate's
    i = int(np.nonzero(used)[0][0])
    sel = port_debug_out["cand_selected"][i].numpy()
    assert sel.sum() == 1
    chosen = float(port_debug_out["bpm"][i])
    assert abs(float(port_debug_out["cand_bpm"][i][sel][0]) - chosen) < 0.75
    assert abs(float(port_debug_out["dbg_base_bpm"][i]) - chosen) > 2.0


@pytest.mark.parametrize("debug", [False, True], ids=["default-config", "candidates-and-debug"])
def test_decode_results_match_jax(jax_debug_out, port_debug_out, debug):
    if debug:
        ref_out, got_out = jax_debug_out, port_debug_out
    else:
        # the default config's own run on the port side; on the JAX side the
        # same dict without the keys those two settings add
        ref_out = reference.without_debug_keys(jax_debug_out)
        got_out = port.analyze_batch(*reference.batch(),
                                     reference.port_config(jpkg.AnalysisConfig()), SR,
                                     device="cpu")
        assert set(got_out) == set(ref_out)
    ref = jax_decode_results(ref_out, SR)
    got = port.decode_results(got_out, SR)
    assert len(got) == len(ref) == len(reference.TRACK_NAMES)
    for r, g in zip(ref, got):
        reference.assert_dicts_match(r.to_dict(), g.to_dict())
        np.testing.assert_allclose(g.beat_grid.beats, r.beat_grid.beats, rtol=0, atol=FLOAT_TOL)
        np.testing.assert_allclose(g.beat_grid.downbeats, r.beat_grid.downbeats, rtol=0,
                                   atol=FLOAT_TOL)
        assert g.beat_grid.bars == g.beat_grid.downbeats
        assert (g.metadata.tempogram_candidates is not None) == debug
    assert got[3].key.name() == "C" and "multi_resolution" in got[2].metadata.methods_used


def test_decode_results_is_the_same_decoder(jax_debug_out):
    """On one and the same dict both decoders give the very same objects."""
    timed = dict(jax_debug_out, processing_time_ms=np.full(4, 12.5, np.float32))
    for r, g in zip(jax_decode_results(timed, SR), port.decode_results(timed, SR)):
        assert g.to_dict() == r.to_dict()
        assert dataclasses.asdict(g.metadata) == dict(dataclasses.asdict(r.metadata),
                                                      algorithm_version="0.1.0-torch")
        assert dataclasses.asdict(g.beat_grid) == dataclasses.asdict(r.beat_grid)
    tensors = {k: torch.as_tensor(v) for k, v in timed.items()}
    for r, g in zip(port.decode_results(timed, SR), port.decode_results(tensors, SR)):
        assert g.to_dict() == r.to_dict()


def test_one_copy_packs_and_cuts_apart():
    """The single-transfer host copy (what tensors on a card go through)."""
    rng = np.random.default_rng(3)
    arrays = {"flag": rng.random(5) > 0.5, "x": rng.random((5, 3)).astype(np.float32),
              "n": rng.integers(0, 9, 5).astype(np.int32), "odd": rng.random(7) > 0.5,
              "big": rng.integers(0, 9, (5, 2)), "empty": np.zeros((5, 0), np.float32)}
    got = pdecode.one_copy({k: torch.as_tensor(v) for k, v in arrays.items()})
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v)
    host = pdecode.to_host(dict(arrays, t=torch.arange(3)), keys=lambda k: k != "odd")
    assert "odd" not in host and host["t"].tolist() == [0, 1, 2]


def _numbers_apart(text: str):
    """The text with every number cut out, and the numbers with the size of
    one unit of their last printed digit."""
    numbers = [(float(m), 10.0 ** -len(m.partition(".")[2]) if "." in m else 0.0)
               for m in re.findall(r"-?\d+\.?\d*", text)]
    return re.sub(r"-?\d+\.?\d*", "#", text), numbers


def test_format_debug_dump_matches_jax(jax_debug_out, port_debug_out):
    port_host = pdecode.to_host(port_debug_out)
    for i in range(len(reference.TRACK_NAMES)):
        want = jdebug.format_debug_dump(jax_debug_out, i, i, gt_bpm=120.0, top_n=5)
        # the same formatter: on the same arrays, the same text
        assert pdebug.format_debug_dump(jax_debug_out, i, i, gt_bpm=120.0, top_n=5) == want
        # and on the port's arrays, the same text up to the printed digits
        got = pdebug.format_debug_dump(port_host, i, i, gt_bpm=120.0, top_n=5)
        (want_text, want_nums), (got_text, got_nums) = _numbers_apart(want), _numbers_apart(got)
        assert got_text == want_text
        assert len(got_nums) == len(want_nums)
        for (g, unit), (w, _) in zip(got_nums, want_nums):
            assert abs(g - w) <= 1.5 * unit, (g, w, got)
    assert "<== selected" in want and "GT support" in want


def test_emit_debug_dump_prints_the_debug_track(port_debug_out):
    cfg = reference.port_config(reference.jax_debug_config())
    sink = io.StringIO()
    pdebug.emit_debug_dump(port_debug_out, cfg, 0, file=sink)
    assert sink.getvalue().startswith("\n=== DEBUG base tempogram (track_id=0) ===")
    assert "escalation: multi_res_triggered=True" in sink.getvalue()
    quiet = io.StringIO()
    pdebug.emit_debug_dump(port_debug_out, port.AnalysisConfig(), 0, file=quiet)
    pdebug.emit_debug_dump(reference.without_debug_keys(port_debug_out), cfg, 0, file=quiet)
    assert quiet.getvalue() == ""


@pytest.fixture(scope="module")
def small_batch():
    samples, lengths = reference.batch()
    return samples[:2, :3 * SR], np.full(2, 3 * SR, np.int32)


@pytest.mark.parametrize("stage", [s for s in STAGES if s])
def test_debug_stop_after_returns_the_jax_keys(small_batch, stage):
    """At every boundary the port returns what the JAX pipeline returns there:
    the same keys, shapes and dtypes (the JAX side is traced, not compiled)."""
    samples, lengths = small_batch
    cfg = jpkg.AnalysisConfig()
    want = jax.eval_shape(
        lambda s, n: jax_analyze_arrays(s, n, cfg, SR, JaxCaps(**SMALL_CAPS),
                                        debug_stop_after=stage),
        jnp.asarray(samples), jnp.asarray(lengths))
    got = port.analyze_batch(samples, lengths, reference.port_config(cfg), SR,
                             port.PipelineCaps(**SMALL_CAPS), device="cpu",
                             debug_stop_after=stage)
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), (stage, k)
        assert got[k].dtype == getattr(torch, v.dtype.name), (stage, k, got[k].dtype, v.dtype)
    full = port.analyze_batch(samples, lengths, reference.port_config(cfg), SR,
                              port.PipelineCaps(**SMALL_CAPS), device="cpu")
    if stage in ("bpm_select", "grid"):
        assert torch.equal(got["bpm"], full["bpm"])
    with pytest.raises(ValueError, match="debug_stop_after"):
        port.analyze_batch(samples, lengths, device="cpu", debug_stop_after="nowhere")


def test_stages_and_stage_timings_keys_match_jax(small_batch):
    assert STAGES == jtiming.STAGES
    samples, lengths = small_batch
    got = ptiming.stage_timings(samples, lengths, caps=port.PipelineCaps(**SMALL_CAPS), reps=1,
                                device="cpu")
    want_keys = [k for s in jtiming.STAGES for k in (s or "full", (s or "full") + "_delta")]
    assert list(got) == want_keys
    assert all(isinstance(v, float) for v in got.values())
    assert all(got[s or "full"] > 0.0 for s in STAGES)
    assert sum(got[k] for k in got if k.endswith("_delta")) == pytest.approx(got["full"])


def test_analyze_batch_timed_stamps_and_logs(small_batch, caplog):
    samples, lengths = small_batch
    with caplog.at_level(logging.DEBUG, logger="stratum_dsp_tpu_torch"):
        out = port.analyze_batch_timed(samples, lengths, caps=port.PipelineCaps(**SMALL_CAPS),
                                       device="cpu")
    stamp = out["processing_time_ms"]
    assert stamp.dtype == torch.float32 and stamp.shape == (2,) and float(stamp[0]) > 0.0
    assert float(stamp[0]) == float(stamp[1])
    assert set(out) - {"processing_time_ms"} == set(
        port.analyze_batch(samples, lengths, caps=port.PipelineCaps(**SMALL_CAPS), device="cpu"))
    line = [r.getMessage() for r in caplog.records if r.name == "stratum_dsp_tpu_torch"]
    assert len(line) == 1 and line[0].startswith("analyze_batch: b=2 ok=2 wall=")
    assert "multi_res triggered=" in line[0] and "low_stability=" in line[0]
    assert port.decode_results(out, SR)[0].metadata.processing_time_ms == float(stamp[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.analyze_batch_timed(samples, lengths)


@pytest.mark.parametrize("mode", list(jmixer.ChannelMixMode), ids=lambda m: m.name)
def test_stereo_to_mono_matches_jax(rng, mode):
    left = rng.standard_normal((3, 257)).astype(np.float32)
    right = rng.standard_normal((3, 257)).astype(np.float32)
    right[:, ::7] = -left[:, ::7]  # equal magnitudes: the left channel wins
    want = np.asarray(jmixer.stereo_to_mono(left, right, mode))
    got = pmixer.stereo_to_mono(torch.as_tensor(left), right, pmixer.ChannelMixMode(mode.value))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert [m.value for m in pmixer.ChannelMixMode] == [m.value for m in jmixer.ChannelMixMode]


def test_result_and_error_types_match_jax():
    for name in ("AnalysisResult", "AnalysisMetadata", "BeatGrid", "TempoCandidateDebug",
                 "AnalysisConfidence", "Key"):
        jf, pf = (dataclasses.fields(getattr(m, name)) for m in (jpkg, port))
        assert [(f.name, f.type) for f in pf] == [(f.name, f.type) for f in jf], name
    assert port.AnalysisResult().to_dict() == jpkg.AnalysisResult().to_dict()
    for idx in range(24):
        jk, pk = jpkg.Key.from_index(idx), port.Key.from_index(idx)
        assert (pk.name(), pk.numerical(), pk.index) == (jk.name(), jk.numerical(), jk.index)
        assert port.Key.from_numerical(pk.numerical()) == pk
    assert port.Key.from_numerical("13A") is None and port.Key.from_numerical("x") is None
    flags = lambda m: {k: v for k, v in vars(m.AnalysisFlag).items() if k.isupper()}  # noqa: E731
    assert flags(port) == flags(jpkg)
    for overall, level in ((0.8, "High"), (0.6, "Medium"), (0.2, "Low")):
        assert port.AnalysisConfidence(overall_confidence=overall).confidence_level() == level
    errors = ("AnalysisError", "InvalidInput", "ProcessingError", "DecodingError",
              "NumericalError", "NotImplementedYet")
    for name in errors:
        assert [c.__name__ for c in getattr(port, name).__mro__] == \
            [c.__name__ for c in getattr(jpkg, name).__mro__]
    legacy = panalysis.LegacyAnalysisMetadata()
    assert dataclasses.asdict(legacy) == dataclasses.asdict(janalysis.LegacyAnalysisMetadata())


def test_the_port_exports_what_the_jax_package_exports():
    """Package boundary: every public name of ``stratum_dsp_tpu`` and of
    ``stratum_dsp_tpu.analysis`` (submodules aside) exists in the port."""
    import types

    for jmod, pmod in ((jpkg, port), (janalysis, panalysis)):
        names = [n for n, v in vars(jmod).items()
                 if not n.startswith("_") and not isinstance(v, types.ModuleType)]
        assert len(names) >= 8
        missing = [n for n in names if not hasattr(pmod, n)]
        assert not missing, (pmod.__name__, missing)
