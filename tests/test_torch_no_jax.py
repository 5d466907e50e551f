"""The port runs where neither JAX nor the JAX package can be imported (the
card's machine has no JAX), under ``SLICE_CONFIG``, under the default
``AnalysisConfig`` and under an opt-in config on the BPM side and one on the
key side; and it runs on the card unless asked for the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["stratum_dsp_tpu"] = None  # and so does any import of the JAX package
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
import stratum_dsp_tpu_torch as port
from stratum_dsp_tpu_torch import testing
caps = port.PipelineCaps(max_onsets=256, max_beats=256, seg_beat_cap=32, max_segments=12)
x = testing.kick_patterns([120.0], 6.0)
out = port.analyze_batch(x, torch.tensor([x.shape[1]]), port.SLICE_CONFIG, 44100, caps,
                         device="cpu")
assert bool(out["ok"][0]) and abs(float(out["bpm"][0]) - 120.0) < 2.0, out["bpm"]
# the default AnalysisConfig, with a trap-zone track that escalates
x = testing.kick_patterns([120.0, 172.0], 6.0)
out = port.analyze_batch(x, torch.tensor([x.shape[1]] * 2), caps=caps, device="cpu")
assert bool(out["multi_res_triggered"][1]), out["multi_res_triggered"]
assert abs(float(out["bpm"][0]) - 120.0) < 2.0, out["bpm"]
# an opt-in config on the BPM side (HPSS onsets, percussive fallback, fusion,
# LOUDNESS normalization) and one on the key side (tuning compensation, the
# HPSS harmonic mask, exact HPCP peaks, the ensemble detector)
bpm_side = port.SLICE_CONFIG.replace(
    enable_hpss_onsets=True, enable_tempogram_percussive_fallback=True, enable_bpm_fusion=True,
    normalization=port.NormalizationMethod.LOUDNESS)
x = testing.kick_patterns([75.0, 120.0], 4.0)
out = port.analyze_batch(x, torch.tensor([x.shape[1]] * 2), bpm_side, 44100, caps, device="cpu")
assert bool(out["ok"].all()) and abs(float(out["bpm"][1]) - 120.0) < 2.0, out["bpm"]
assert bool(out["percussive_triggered"][0]), out["percussive_triggered"]
key_side = port.SLICE_CONFIG.replace(
    enable_key_tuning_compensation=True, enable_key_hpss_harmonic=True,
    enable_key_harmonic_mask=False, key_hpcp_approx_peaks=False, enable_key_ensemble=True)
x = testing.c_major_scale()[None, :]
out = port.analyze_batch(x, torch.tensor([x.shape[1]]), key_side, 44100, caps, device="cpu")
assert bool(out["ok"][0]) and int(out["key_idx"][0]) == 0, out["key_idx"]
# the scale-out: the default config on a 1-D tracks mesh and a (tracks, time)
# mesh of repeated CPU devices
from stratum_dsp_tpu_torch.parallel import mesh as pmesh
cpu = torch.device("cpu")
x = testing.kick_patterns([120.0, 172.0], 4.0)
n = torch.tensor([x.shape[1]] * 2)
m2 = pmesh.make_mesh([cpu] * 4, n_time=2)
for m, batch in ((pmesh.make_mesh([cpu] * 2), x), (m2, x.numpy())):  # 2-D: blocks cut from numpy
    sharded = pmesh.analyze_batch_sharded(pmesh.pad_batch_for_mesh(batch, m), n,
                                          port.AnalysisConfig(), 44100, caps, m)
    assert abs(float(sharded["bpm"][0]) - 120.0) < 2.0, sharded["bpm"]
assert sys.modules["jax"] is None and sys.modules["stratum_dsp_tpu"] is None
print("bpm", float(out["bpm"][0]))
"""


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT.format(repo=str(REPO))],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("bpm ")


CLI_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["stratum_dsp_tpu"] = None
sys.path.insert(0, {repo!r})
import contextlib, importlib, io, json, pkgutil, wave
import numpy as np
import torch
torch.set_num_threads(2)
import stratum_dsp_tpu_torch as port
# every module of the port imports (the CLIs, the decoder, the host runtime)
names = [m.name for m in pkgutil.walk_packages(port.__path__, "stratum_dsp_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "stratum_dsp_tpu_torch.cli.analyze_batch" in names and len(names) > 40, names
from stratum_dsp_tpu_torch import testing
from stratum_dsp_tpu_torch.cli import analyze_batch, analyze_file
x = testing.kick_patterns([120.0], 6.0)[0].numpy()
path = {tmp!r} + "/kick.wav"
with wave.open(path, "wb") as w:
    w.setnchannels(1); w.setsampwidth(2); w.setframerate(44100)
    w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())
flags = ["--device", "cpu", "--max-onsets", "256", "--max-beats", "256"]
sink = io.StringIO()
with contextlib.redirect_stdout(sink):
    assert analyze_file.main([path, "--json", *flags]) == 0
    assert analyze_batch.main([path, path, *flags]) == 0
one, *two = [json.loads(line) for line in sink.getvalue().strip().splitlines()]
assert abs(one["bpm"] - 120.0) < 2.0 and one["beat_count"] > 0, one
assert [r["file"] for r in two] == [path, path] and two[0]["bpm"] == one["bpm"], two
# the battery runner, its synthesis, scoring and runner, and the FLAC writer
from stratum_dsp_tpu_torch.testing import flac_writer
from stratum_dsp_tpu_torch.validation import run_battery
with contextlib.redirect_stdout(io.StringIO()) as report:
    assert run_battery.main(["--families", "fractional", "--limit", "1", "--batch-size", "1",
                             "--device", "cpu", "--wav-dir", {tmp!r} + "/wavs",
                             "--out", {tmp!r} + "/battery.csv"]) == 0
assert json.loads(report.getvalue())["overall"]["analyzed"] == 1
flac_writer.write_flac({tmp!r} + "/x.flac", (x * 3000).astype(np.int16), 44100)
assert sys.modules["jax"] is None and sys.modules["stratum_dsp_tpu"] is None
print("bpm", one["bpm"])
"""


def test_clis_import_and_run_without_jax(tmp_path):
    """Every module of the port imports, both CLIs run file in, JSON out, and
    the battery runner runs a track, where neither JAX nor the JAX package
    can be imported."""
    script = CLI_SCRIPT.format(repo=str(REPO), tmp=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("bpm ")


def test_cli_modules_run_as_programs(tmp_path):
    """``python -m stratum_dsp_tpu_torch.cli.analyze_file`` without ``--device``
    and without a card fails with the pipeline's error; it does not carry on
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    import wave

    path = str(tmp_path / "tone.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(44100)
        w.writeframes((np.sin(np.arange(44100) * 0.05) * 8000).astype(np.int16).tobytes())
    for module in ("analyze_file", "analyze_batch"):
        proc = subprocess.run([sys.executable, "-m", f"stratum_dsp_tpu_torch.cli.{module}", path],
                              capture_output=True, text=True, timeout=300, cwd=REPO)
        assert proc.returncode != 0 and proc.stdout.strip() == "", (module, proc.stdout)
        assert "RuntimeError" in proc.stderr, proc.stderr[-2000:]
        assert "no CUDA device" in proc.stderr, proc.stderr[-2000:]


FORBIDDEN_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|stratum_dsp_tpu)(\.|\s|$)")


def test_no_jax_import_in_port_sources():
    """No module of the port, nor chip_smoke.py, nor the port's bench script
    imports jax or anything of the JAX package (``stratum_dsp_tpu_torch`` is
    the port itself)."""
    files = sorted((REPO / "stratum_dsp_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "scripts" / "torch_port_bench.py"]
    assert len(files) > 40
    names = {str(f.relative_to(REPO)) for f in files}
    assert {"analyze_file.py", "analyze_batch.py", "decode.py", "timing.py", "result.py",
            "hpss.py", "threshold.py", "peak_picking.py", "normalization.py"} <= {
        f.name for f in files}
    port_dir = "stratum_dsp_tpu_torch/"
    assert {port_dir + f for f in (
        "io/decode.py", "testing/__init__.py", "testing/synth.py", "testing/battery.py",
        "testing/flac_writer.py", "validation/__init__.py", "validation/keys.py",
        "validation/beats.py", "validation/id3.py", "validation/run_validation.py",
        "validation/run_battery.py", "validation/sweep_tempogram_tuning.py",
        "parallel/__init__.py", "parallel/mesh.py", "parallel/timeblocks.py",
        "parallel/multihost.py", "ml/__init__.py", "ml/refinement.py")} <= names
    for path in files:
        for line in path.read_text().splitlines():
            assert not FORBIDDEN_IMPORT.match(line), (path, line)
    for line in ("import jax", "from jax import numpy", "import jax.numpy as jnp",
                 "import stratum_dsp_tpu", "    from stratum_dsp_tpu.config import AnalysisConfig"):
        assert FORBIDDEN_IMPORT.match(line), line
    for line in ("import stratum_dsp_tpu_torch as port", "import jaxtyping",
                 "from stratum_dsp_tpu_torch import testing"):
        assert not FORBIDDEN_IMPORT.match(line), line


def _tiny_batch():
    import stratum_dsp_tpu_torch as port
    from stratum_dsp_tpu_torch import testing

    x = testing.kick_patterns([120.0], 3.0).numpy()
    caps = port.PipelineCaps(max_onsets=128, max_beats=64, seg_beat_cap=16, max_segments=4)
    return port, x, np.asarray([x.shape[1]]), caps


def test_default_device_is_the_card_and_raises_without_one():
    """``analyze_batch`` without ``device`` never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    port, x, lengths, caps = _tiny_batch()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.analyze_batch(x, lengths, port.SLICE_CONFIG, caps=caps)


def test_cpu_runs_when_asked_for():
    port, x, lengths, caps = _tiny_batch()
    out = port.analyze_batch(x, lengths, port.SLICE_CONFIG, caps=caps, device="cpu")
    assert out["bpm"].device.type == "cpu" and bool(out["ok"][0])
