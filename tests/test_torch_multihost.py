"""Several processes on the port's tracks axis, and the tempogram tuning
sweep over files: the two-process smoke of ``parallel.multihost`` on the CPU
(gloo), spawned in a subprocess with a free port, and the sweep tool's
``run_config`` and CLI on two WAVs. Also the time blocks on the card (a
``cuda`` test): this file imports no JAX, so it runs on the card's machine.
"""

import json
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import stratum_dsp_tpu_torch as port
from stratum_dsp_tpu_torch.features.period import novelty as pnov
from stratum_dsp_tpu_torch.parallel import mesh as pmesh
from stratum_dsp_tpu_torch.parallel import multihost
from stratum_dsp_tpu_torch.parallel import timeblocks as ptb
from stratum_dsp_tpu_torch.testing import kick_pattern, pad_batch
from stratum_dsp_tpu_torch.validation import sweep_tempogram_tuning as sweep
from stratum_dsp_tpu_torch.validation.run_validation import bucket_for

REPO = Path(__file__).resolve().parents[1]
SR = 44100


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_multihost_two_process_smoke_on_the_cpu():
    """Two processes of four CPU devices each, joined over gloo: each checks
    its rows against the unsharded port and every gathered BPM."""
    proc = subprocess.run(
        [sys.executable, "-m", "stratum_dsp_tpu_torch.parallel.multihost", "--device", "cpu",
         "--port", str(multihost.free_port())],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    assert "multihost smoke: OK" in out
    for i in range(multihost.N_PROC * multihost.LOCAL_DEVICES):
        assert f"track {i}: bpm=" in out and "MISS" not in out, out[-4000:]
    assert out.count("gloo over cpu, 8 tracks gathered") == multihost.N_PROC


def test_multihost_without_a_card_refuses_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert multihost.main(["--device", "cuda"]) == 2


def _write_wav(path: Path, x: np.ndarray) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16).tobytes())


@pytest.fixture(scope="module")
def two_wavs(tmp_path_factory):
    """Two 6 s kick WAVs and a batch CSV giving their BPM (the second one
    2 BPM off its seed, so +-2 holds and MAE is not 0)."""
    d = tmp_path_factory.mktemp("sweep")
    rows = []
    for i, bpm in enumerate((120.0, 128.0)):
        path = d / f"kick_{i}.wav"
        _write_wav(path, kick_pattern(bpm, 6.0))
        rows.append({"file": str(path), "bpm": str(bpm + 2.0 * i)})
    csv_path = d / "batch.csv"
    csv_path.write_text("file,bpm\n" + "".join(f"{r['file']},{r['bpm']}\n" for r in rows))
    return csv_path, rows


def test_sweep_run_config_scores_the_files(two_wavs):
    """``run_config`` gives +-2 BPM accuracy, MAE and the count over the
    rows with a ground-truth BPM, from the results the pipeline gives the
    same samples at their bucket's padded length."""
    from stratum_dsp_tpu_torch.io.decode import decode_batch

    _, rows = two_wavs
    decoded = decode_batch([r["file"] for r in rows], target_sr=SR)
    cfg = port.SLICE_CONFIG
    score = sweep.run_config(cfg, decoded, rows, batch_size=8, device="cpu")
    n = len(decoded[0][0])
    batch = np.zeros((2, bucket_for(n)), np.float32)
    for j, (x, _, _) in enumerate(decoded):
        batch[j, :len(x)] = x
    res = port.decode_results(port.analyze_batch(batch, np.full(2, n), cfg, SR, device="cpu"), SR)
    errs = np.abs(np.asarray([r.bpm for r in res]) - np.asarray([120.0, 130.0]))
    assert score == {"acc2": round(float(np.mean(errs <= 2.0)), 4),
                     "mae": round(float(errs.mean()), 3), "n": 2}
    assert score["acc2"] == 1.0 and score["mae"] > 0.5


def test_sweep_cli_prints_the_leaderboard(two_wavs, capsys):
    csv_path, _ = two_wavs
    rc = sweep.main([str(csv_path), "--device", "cpu", "--param", "enable_bpm_fusion",
                     "false", "true"])
    assert rc == 0
    board = json.loads(capsys.readouterr().out)
    assert [set(r) for r in board] == [{"enable_bpm_fusion", "acc2", "mae", "n"}] * 2
    assert sorted(r["enable_bpm_fusion"] for r in board) == [False, True]
    assert board[0]["acc2"] >= board[1]["acc2"] and all(r["n"] == 2 for r in board)


@pytest.mark.cuda
def test_time_blocks_launch_kernel_d_on_card():
    """On the card every chunk of every time block launches the fused
    novelty kernel (no plain fallback), and the features equal the
    unsharded path's on every valid frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda:0")
    tracks = [torch.as_tensor(kick_pattern(bpm, secs)) for bpm, secs in ((120.0, 3.0),
                                                                          (132.0, 2.4))]
    samples, lengths = pad_batch(tracks, pad_to=2 * pmesh.TIME_QUANTUM * 65)
    s, n = samples.to(dev), lengths.to(dev)
    cfg = port.AnalysisConfig()
    port.reset_launch_counts()
    feats, fc, nf = ptb.compute_bpm_spectral_features_sharded(
        s, n, cfg, SR, 2048, 512, pmesh.make_mesh([dev] * 4, n_time=2), chunk_frames=48)
    fpb = samples.shape[1] // 2 // 512
    assert nf == 2 * fpb and port.fused_novelty_features.launches == 2 * 2 * -(-fpb // 48)
    ref, _, _ = pnov.compute_bpm_spectral_features(s, n, cfg, SR, 2048, 512)
    for k in ("superflux", "energy", "hfc", "mel"):
        for bi, c in enumerate(fc.tolist()):
            torch.testing.assert_close(feats[k][bi, :c], ref[k][bi, :c], rtol=2e-4, atol=2e-4)
