"""The port's file path (``stratum_dsp_tpu_torch``: ``io/decode.py``,
``cli/args.py``, ``cli/analyze_file.py``, ``cli/analyze_batch.py``) against
the JAX package, on the CPU.

The decoders are held to each other sample for sample (WAV at every width,
stereo in both mix modes, FLAC, through the native library and through the
stdlib fallback). The CLIs run in-process with ``--device cpu`` on WAVs written
into ``tmp_path``; what they print has the keys of ``AnalysisResult.to_dict``
and the values that ``decode_results`` gives for the JAX pipeline's output on
the same samples (``tests/torch_port_reference.py``; floats at the bounds of
``assert_outputs_match``, everything else exactly). The JAX CLIs are not run:
only their parsers are built, to compare the flag sets.
"""

import json
import wave

import numpy as np
import pytest
import torch

from stratum_dsp_tpu.analysis import decode_results as jax_decode_results
from stratum_dsp_tpu.cli import analyze_batch as jbatch_cli
from stratum_dsp_tpu.cli import analyze_file as jfile_cli
from stratum_dsp_tpu.cli import args as jargs
from stratum_dsp_tpu.io import decode as jdecode
from stratum_dsp_tpu.testing.flac_writer import write_flac
import stratum_dsp_tpu_torch as port
from stratum_dsp_tpu_torch.cli import analyze_batch as pbatch_cli
from stratum_dsp_tpu_torch.cli import analyze_file as pfile_cli
from stratum_dsp_tpu_torch.cli import args as pargs
from stratum_dsp_tpu_torch.io import decode as pdecode

import torch_port_reference as reference

torch.set_num_threads(2)

SR = reference.SAMPLE_RATE
# what the JAX CLIs have for XLA alone, and what the port has in its place
JAX_ONLY_FLAGS, PORT_ONLY_FLAGS = {"--debug-nans"}, {"--device"}


def write_wav(path, frames: np.ndarray, width: int = 2, sr: int = SR) -> str:
    """``frames [T]`` or ``[T, channels]`` of integer samples as PCM of
    ``width`` bytes (8-bit unsigned, the others signed little-endian)."""
    frames = np.asarray(frames)
    channels = 1 if frames.ndim == 1 else frames.shape[1]
    if width == 3:
        raw = frames.astype("<i4").reshape(-1, 1).view(np.uint8)[:, :3].tobytes()
    else:
        raw = frames.astype({1: np.uint8, 2: "<i2", 4: "<i4"}[width]).tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw)
    return str(path)


@pytest.fixture(scope="module")
def jax_results():
    """``to_dict()`` of the JAX package's results for the reference batch
    under the default config, one per track."""
    out = reference.without_debug_keys(reference.jax_debug_output())
    return [r.to_dict() for r in jax_decode_results(out, SR)]


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """The reference batch as 16-bit mono WAVs, named after the tracks."""
    d = tmp_path_factory.mktemp("tracks")
    return [write_wav(d / f"{name}.wav", x) for name, x in
            zip(reference.TRACK_NAMES, reference.tracks16())]


# --- the decoder ---------------------------------------------------------


@pytest.mark.parametrize("width", [1, 2, 3, 4])
@pytest.mark.parametrize("layout", ["mono", "stereo-average", "stereo-dominant"])
def test_wav_decodes_as_in_the_jax_package(tmp_path, rng, width, layout):
    top = {1: 255, 2: 2 ** 15 - 1, 3: 2 ** 23 - 1, 4: 2 ** 31 - 1}[width]
    low = 0 if width == 1 else -top - 1
    frames = rng.integers(low, top + 1, (3001,) if layout == "mono" else (3001, 2))
    if layout != "mono":
        frames[::5, 1] = frames[::5, 0]  # equal magnitudes: the left channel wins
    path = write_wav(tmp_path / "x.wav", frames, width)
    mix = pdecode.MIX_DOMINANT if layout == "stereo-dominant" else pdecode.MIX_AVERAGE
    assert (pdecode.MIX_AVERAGE, pdecode.MIX_DOMINANT) == (jdecode.MIX_AVERAGE,
                                                           jdecode.MIX_DOMINANT)
    want, want_sr = jdecode.decode_file(path, 0, mix)
    got, got_sr = pdecode.decode_file(path, 0, mix)
    assert got_sr == want_sr == SR and got.dtype == np.float32 and got.shape == (3001,)
    np.testing.assert_array_equal(got, want)
    # the stdlib fallback, which decodes where g++ is missing
    want, _ = jdecode._decode_wav_python(path, mix)
    got, got_sr = pdecode._decode_wav_python(path, mix)
    assert got_sr == SR
    np.testing.assert_array_equal(got, want)


def test_decoder_backend_is_native_here():
    assert jdecode.native_lib() is not None
    assert pdecode.native_lib() is not None and pdecode.decoder_backend() == "native"
    assert pdecode.ffmpeg_available() == jdecode.ffmpeg_available()
    assert pdecode._ERR_NAMES == jdecode._ERR_NAMES


def test_flac_and_resampling_decode_as_in_the_jax_package(tmp_path):
    x16 = reference.tracks16()[1][:3 * SR].copy()
    x16[:4096] = 123  # a constant block, for the CONSTANT subframe path
    wav, flac = write_wav(tmp_path / "sig.wav", x16), str(tmp_path / "sig.flac")
    write_flac(flac, x16, SR, block_size=4096)
    for path, target in ((flac, 0), (wav, 22050), (flac, 48000)):
        want, want_sr = jdecode.decode_file(path, target)
        got, got_sr = pdecode.decode_file(path, target)
        assert got_sr == want_sr == (target or SR)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pdecode.decode_file(flac)[0], pdecode.decode_file(wav)[0])
    np.testing.assert_array_equal(pdecode.decode_file(wav)[0],
                                  x16.astype(np.float32) / np.float32(32768.0))


@pytest.mark.parametrize("backend", ["native", "stdlib"])
def test_decode_batch_reports_what_it_cannot_decode(tmp_path, monkeypatch, backend):
    x16 = reference.tracks16()[0][:SR]
    wav, flac, bad = (write_wav(tmp_path / "a.wav", x16), str(tmp_path / "b.flac"),
                      str(tmp_path / "c.flac"))
    write_flac(flac, x16, SR)
    with open(bad, "wb") as f:
        f.write(b"not a flac at all")
    want = jdecode.decode_batch([wav, flac, bad], target_sr=SR)
    if backend == "stdlib":
        monkeypatch.setattr(pdecode, "native_lib", lambda: None)
        assert pdecode.decoder_backend() == "stdlib"
    got = pdecode.decode_batch([wav, flac, bad], target_sr=SR, n_threads=2)
    assert [sr for _, sr, _ in got][:1] == [SR] and got[0][2] is None
    np.testing.assert_array_equal(got[0][0], want[0][0])
    assert got[2][0] is None and got[2][1] == 0 and got[2][2]
    if backend == "native":
        assert got[2][2] == want[2][2]
        np.testing.assert_array_equal(got[1][0], want[1][0])
    else:  # the fallback reads WAV only
        assert got[1][0] is None and got[1][2]
        with pytest.raises(wave.Error):
            pdecode.decode_file(flac)
        np.testing.assert_array_equal(pdecode.decode_file(wav, 22050)[0].shape, (SR // 2,))


# --- the flags -----------------------------------------------------------


def _flags(parser) -> dict:
    return {opt: (a.dest, a.default, a.nargs, a.choices and tuple(a.choices))
            for a in parser._actions for opt in a.option_strings if opt.startswith("--")}


@pytest.mark.parametrize("which", ["analyze_file", "analyze_batch"])
def test_the_parsers_have_the_jax_clis_flags(which):
    jcli, pcli = {"analyze_file": (jfile_cli, pfile_cli),
                  "analyze_batch": (jbatch_cli, pbatch_cli)}[which]
    want, got = _flags(jcli.build_parser()), _flags(pcli.build_parser())
    assert set(got) - set(want) == PORT_ONLY_FLAGS
    assert set(want) - set(got) == JAX_ONLY_FLAGS
    assert len(got) > 100  # every AnalysisConfig field has its flag
    for flag in set(got) & set(want):
        assert got[flag] == want[flag], flag
    assert pbatch_cli.DEFAULT_BUCKETS == jbatch_cli.DEFAULT_BUCKETS
    for n in (1, 60 * SR, 60 * SR + 1, 300 * SR, 500 * SR):
        assert pbatch_cli.bucket_for(n, SR) == jbatch_cli.bucket_for(n, SR)


def test_config_from_args_builds_the_jax_config():
    argv = ["x.wav", "--hop-size", "256", "--enable-tempogram-multi-resolution", "false",
            "--min-bpm", "70.5", "--debug-track-id", "3", "--debug-gt-bpm", "128",
            "--emit-tempogram-candidates", "yes", "--key-template-set", "temperley",
            "--normalization", "peak", "--onset-consensus-weights", "0.4,0.3,0.2,0.1",
            "--key-multi-scale-lengths", "60,240"]
    want = jargs.config_from_args(jfile_cli.build_parser().parse_args(argv))
    got = pargs.config_from_args(pfile_cli.build_parser().parse_args(argv))
    assert got == reference.port_config(want)
    assert (got.hop_size, got.debug_track_id, got.min_bpm) == (256, 3, 70.5)
    assert got.onset_consensus_weights == (0.4, 0.3, 0.2, 0.1)
    assert got.key_multi_scale_lengths == (60, 240)
    assert pargs.config_from_args(pfile_cli.build_parser().parse_args(["x.wav"])) \
        == port.AnalysisConfig()
    with pytest.raises(SystemExit):
        pfile_cli.build_parser().parse_args(["x.wav", "--enable-bpm-fusion", "maybe"])


# --- the CLIs ------------------------------------------------------------


@pytest.mark.parametrize("track", [1, 2], ids=["kick_120", "kick_172-escalated"])
def test_analyze_file_prints_the_jax_schema_and_values(wavs, jax_results, capsys, track):
    assert pfile_cli.main([wavs[track], "--json", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert list(got) == list(port.AnalysisResult().to_dict())
    reference.assert_dicts_match(jax_results[track], got, skip=("processing_time_ms",))
    assert got["processing_time_ms"] > 0.0 and got["tempogram_candidates"] is None
    assert got["tempogram_multi_res_used"] == (track == 2)


def test_analyze_file_human_readable_and_debug_dump(wavs, jax_results, capsys):
    assert pfile_cli.main([wavs[1], "--device", "cpu", "--debug-track-id", "0",
                           "--debug-gt-bpm", "120", "--mix-mode", "dominant"]) == 0
    out, err = capsys.readouterr()
    assert out.splitlines()[0] == f"file: {wavs[1]}"
    assert abs(float(out.split("bpm: ")[1].split()[0]) - jax_results[1]["bpm"]) < 2e-2
    assert f"key: {jax_results[1]['key']} / {jax_results[1]['key_numerical']}" in out
    assert f"grid: {jax_results[1]['beat_count']} beats" in out
    assert "=== DEBUG base tempogram (track_id=0) ===" in err and "GT support" in err


def test_analyze_file_never_carries_on_on_the_cpu(wavs, jax_results, tmp_path, capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pfile_cli.main([wavs[1], "--json"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pbatch_cli.main([wavs[1], "-o", str(tmp_path / "out.jsonl")])
    # an opt-in flag runs: fusion rescales the confidence and keeps the BPM
    assert pfile_cli.main([wavs[1], "--json", "--device", "cpu", "--enable-bpm-fusion", "true",
                           "--enable-key-ensemble", "true"]) == 0
    fused = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(fused["bpm"] - jax_results[1]["bpm"]) < 2e-2
    assert fused["bpm_confidence"] != jax_results[1]["bpm_confidence"]
    # empty audio is an error record on stderr and exit code 1
    assert pfile_cli.main([write_wav(tmp_path / "empty.wav", np.zeros(0, np.int16)),
                           "--json", "--device", "cpu"]) == 1


def test_analyze_batch_buckets_and_jsonl(wavs, jax_results, tmp_path, capsys):
    """Three WAVs of two buckets (8 s, 8 s and 61 s), one file that is no
    audio, and a batch size that splits them into two decode chunks."""
    long16 = np.tile(reference.tracks16()[1], 9)[:61 * SR]
    long_wav = write_wav(tmp_path / "long.wav", long16)
    bad = tmp_path / "noise.flac"
    bad.write_bytes(b"no audio in here")
    paths = [long_wav, wavs[1], str(bad), wavs[2]]
    out_path = tmp_path / "out.jsonl"
    assert pbatch_cli.main([*paths, "-o", str(out_path), "--device", "cpu", "--batch-size", "3",
                            "--decode-threads", "2", "--emit-tempogram-candidates", "true"]) == 0
    assert "analyzed 3/4 tracks in" in capsys.readouterr().err
    records = [json.loads(line) for line in out_path.read_text().splitlines()]
    assert sorted(r["file"] for r in records) == sorted(paths)
    by_file = {r["file"]: r for r in records}
    assert set(by_file[str(bad)]) == {"file", "error"} and by_file[str(bad)]["error"]
    # within a chunk the error comes first, then the buckets in ascending length
    assert [r["file"] for r in records] == [str(bad), wavs[1], long_wav, wavs[2]]
    schema = ["file", *port.AnalysisResult().to_dict()]
    for track, path in ((1, wavs[1]), (2, wavs[2])):
        rec = by_file[path]
        assert list(rec) == schema
        # padded to its 60 s bucket, the track gives what it gives alone
        reference.assert_dicts_match(
            jax_results[track], {k: v for k, v in rec.items() if k != "file"},
            skip=("processing_time_ms", "tempogram_candidates"))
        assert len(rec["tempogram_candidates"]) > 0
        assert sum(c["selected"] for c in rec["tempogram_candidates"]) == 1
    rec = by_file[long_wav]
    assert list(rec) == schema
    assert 60.0 < rec["duration_seconds"] <= 61.0  # past the 60 s bucket (silence trimmed)
    assert abs(rec["bpm"] - 120.0) < 2.0 and rec["beat_count"] > 100
    # stdout is the default sink
    assert pbatch_cli.main([wavs[1], "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1 and json.loads(line[0])["file"] == wavs[1]
