"""The port's ``parallel/`` against the JAX package's on the CPU: the
time-sharded frame RMS (bit for bit), BPM features and key STFT, the full
default pipeline on a (tracks, time) mesh, and the mesh API. JAX runs on the
8 virtual CPU devices of ``tests/conftest.py``; the port's meshes repeat
``torch.device("cpu")``.
"""

import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from stratum_dsp_tpu.analysis.pipeline import PipelineCaps as JaxCaps
from stratum_dsp_tpu.config import AnalysisConfig as JaxConfig
from stratum_dsp_tpu.features.period import novelty as jnov
from stratum_dsp_tpu.parallel import mesh as jmesh
from stratum_dsp_tpu.parallel import timeblocks as jtb
from stratum_dsp_tpu.testing import c_major_scale, kick_pattern, pad_batch

import stratum_dsp_tpu_torch as port
from stratum_dsp_tpu_torch.features.period import novelty as pnov
from stratum_dsp_tpu_torch.ops import cuda_build
from stratum_dsp_tpu_torch.parallel import mesh as pmesh
from stratum_dsp_tpu_torch.parallel import timeblocks as ptb
from stratum_dsp_tpu_torch.testing import assert_outputs_match

SR = 44100
CPU = torch.device("cpu")
JCFG = JaxConfig()
PCFG = port.AnalysisConfig.from_dict(dataclasses.asdict(JCFG))
NOVELTY_REL_TOL = 1e-5  # the novelty reducer's (tests/test_torch_novelty.py)
UNSHARDED_TOL = 2e-4  # sharded against unsharded features (tests/test_timeblocks.py)
# the test_timeblocks.py full-pipeline case: its tracks and capacities
PIPELINE_CAPS = dict(max_onsets=256, max_beats=256, seg_beat_cap=16, max_segments=6)
PIPELINE_TRACKS = ((74.0, 6.0), (132.0, 6.0), (101.0, 5.0), (156.0, 6.0))

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jax_mesh(n_tracks: int, n_time: int) -> JaxMesh:
    return JaxMesh(np.asarray(jax.devices()[:n_tracks * n_time]).reshape(n_tracks, n_time),
                   ("tracks", "time"))


def port_mesh(n_tracks: int, n_time: int) -> pmesh.Mesh:
    return pmesh.make_mesh([CPU] * (n_tracks * n_time), n_time=n_time)


def padded(tracks, n_time: int):
    """``pad_batch`` with T right-padded to a multiple of n_time * 1024."""
    t = max(len(x) for x in tracks)
    m = n_time * pmesh.TIME_QUANTUM
    return pad_batch(tracks, pad_to=-(-t // m) * m)


def tensors(samples, lengths):
    return torch.as_tensor(samples), torch.as_tensor(np.asarray(lengths, np.int64))


# --- frame RMS: bit for bit --------------------------------------------------

@pytest.mark.parametrize("n_time,hop", [(2, 512), (4, 512), (2, 1024), (4, 1024)],
                         ids=["time2-onsets", "time4-onsets", "time2-silence", "time4-silence"])
def test_frame_rms_sharded_matches_jax_bit_for_bit(rng, n_time, hop):
    """The onset (hop 512) and silence (hop 1024) RMS grids: a whole track,
    one that ends inside the last block, one shorter than a block, one
    shorter than a frame."""
    t = 65536
    lengths = np.asarray([t, 60001, 9000, 1500])
    assert lengths[1] > t - t // n_time and lengths[2] < t // n_time
    samples = (rng.standard_normal((4, t)) * 0.3).astype(np.float32)
    samples[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    want, want_n = jtb.frame_rms_sharded(jnp.asarray(samples), jnp.asarray(lengths, jnp.int32),
                                         2048, hop, jax_mesh(2, n_time))
    got, got_n = ptb.frame_rms_sharded(*tensors(samples, lengths), 2048, hop,
                                       port_mesh(2, n_time))
    assert got.shape == (4, t // hop)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


# --- BPM features ------------------------------------------------------------

# padded to 3 s: 2.4 s ends inside the last block of a time axis of 4, 0.5 s
# inside the first block
BPM_TRACKS = ((120.0, 3.0), (132.0, 2.4), (101.0, 0.5), (90.0, 1.6))
FEATURE_KEYS = ("superflux", "superflux2", "energy", "hfc", "onset_sflux", "mel")


def _bpm_features(n_time: int, chunk_frames: int, bf16: bool = True):
    """(JAX sharded, port sharded, JAX unsharded, port unsharded) features of
    BPM_TRACKS, frame counts, frames a block."""
    jcfg = JCFG.replace(stft_bf16=bf16)
    pcfg = PCFG.replace(stft_bf16=bf16)
    samples, lengths = padded([kick_pattern(bpm, secs) for bpm, secs in BPM_TRACKS], n_time)
    js, jn = jnp.asarray(samples), jnp.asarray(lengths)
    jsh, jfc, jnf = jtb.compute_bpm_spectral_features_sharded(
        js, jn, jcfg, SR, 2048, 512, jax_mesh(2, n_time), chunk_frames=chunk_frames)
    jun, _, _ = jnov.compute_bpm_spectral_features(js, jn, jcfg, SR, 2048, 512)
    s, n = tensors(samples, lengths)
    psh, pfc, pnf = ptb.compute_bpm_spectral_features_sharded(s, n, pcfg, SR, 2048, 512,
                                                              port_mesh(2, n_time),
                                                              chunk_frames=chunk_frames)
    pun, _, _ = pnov.compute_bpm_spectral_features(s, n, pcfg, SR, 2048, 512)
    fpb = samples.shape[1] // n_time // 512
    assert pnf == jnf == n_time * fpb
    np.testing.assert_array_equal(pfc.numpy(), np.asarray(jfc))
    assert psh["band_names"] == jsh["band_names"]
    as_np = lambda f: {k: np.asarray(f[k]) for k in FEATURE_KEYS}  # noqa: E731
    return as_np(jsh), as_np(psh), as_np(jun), as_np(pun), pfc.numpy(), fpb


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _valid(x, fc):
    """The valid frames of every track, concatenated."""
    return np.concatenate([x[bi, :n] for bi, n in enumerate(fc)])


@pytest.mark.parametrize("n_time", [2, 4])
def test_bpm_features_sharded_match_jax_and_unsharded(n_time):
    """One chunk a block. With the f32 STFT the JAX package's sharded
    features within the reducer's 1e-5; with the bf16 STFT no further from
    them than the two packages' unsharded features are from each other (a
    bf16 basis entry in ~0.1% differs by an ulp, ROADMAP.md Queue 3); and
    the port's unsharded features within 2e-4 on every valid frame."""
    jsh, psh, _, pun, fc, _ = _bpm_features(n_time, 512, bf16=False)
    for k in FEATURE_KEYS:
        assert psh[k].shape == jsh[k].shape, k
        assert _rel(psh[k], jsh[k]) < NOVELTY_REL_TOL, (k, _rel(psh[k], jsh[k]))
    jsh, psh, jun, pun, fc, _ = _bpm_features(n_time, 512)
    for k in FEATURE_KEYS:
        np.testing.assert_allclose(_valid(psh[k], fc), _valid(pun[k], fc), rtol=UNSHARDED_TOL,
                                   atol=UNSHARDED_TOL, err_msg=k)
        between_packages = _rel(_valid(pun[k], fc), _valid(jun[k], fc))
        assert _rel(psh[k], jsh[k]) <= between_packages + NOVELTY_REL_TOL, k


def test_bpm_features_sharded_over_several_chunks_a_block():
    """66 frames a block in 48-frame chunks. The port's features equal the
    unsharded ones on every valid frame. The JAX function clamps the last
    chunk's ``dynamic_slice`` (frames 48..65 of a block are read 30 frames
    early), so it agrees with the port everywhere but there, and there it is
    off its own unsharded features (ROADMAP.md Queue 3)."""
    jsh, psh, jun, pun, fc, fpb = _bpm_features(4, 48, bf16=False)
    assert fpb == 66
    clamped = np.zeros(4 * fpb, bool)
    for j in range(4):
        clamped[j * fpb + 48:(j + 1) * fpb] = True
    n = int(fc[0])
    for k in ("superflux", "energy", "hfc", "mel"):
        np.testing.assert_allclose(_valid(psh[k], fc), _valid(pun[k], fc), rtol=UNSHARDED_TOL,
                                   atol=UNSHARDED_TOL, err_msg=k)
        assert _rel(psh[k][:, ~clamped], jsh[k][:, ~clamped]) < NOVELTY_REL_TOL, k
        scale = np.abs(jun[k]).max()
        jax_off = np.abs(jsh[k][0, :n] - jun[k][0, :n]).reshape(n, -1).max(axis=-1) / scale
        assert jax_off[~clamped[:n]].max() < NOVELTY_REL_TOL, k
        assert jax_off[clamped[:n]].max() > 1e-2, k


# --- the key STFT ------------------------------------------------------------

def test_key_stft_sharded_matches_jax():
    """The key path's call: 8192/512, a 12-frame halo on each side, no
    previous frames, 931 bins, bf16. Per-frame energy of the central frames
    within 1% (the bf16 STFT's tolerance, tests/test_stft.py)."""
    halo, keep = 12, 931
    scale = c_major_scale()
    samples, lengths = padded([np.tile(scale, 2)[:int(3.5 * SR)], kick_pattern(101.0, 3.0)], 2)

    def jax_reducer(spec, fidx, fvalid, carry):
        c = spec.shape[1] - 2 * halo
        central = jnp.where(fvalid[:, halo:halo + c, None], spec[:, halo:halo + c], 0.0)
        return {"e": jnp.sum(central * central, axis=-1)}, carry

    def port_reducer(spec, fidx, fvalid, carry):
        c = spec.shape[1] - 2 * halo
        central = torch.where(fvalid[:, halo:halo + c, None], spec[:, halo:halo + c], 0.0)
        return {"e": (central * central).sum(dim=-1)}, carry

    kw = dict(prev_frames=0, halo_frames=halo, keep_bins=keep, chunk_frames=512, bf16=True)
    want, jnf, jfc = jtb.stft_reduce_sharded(jnp.asarray(samples), jnp.asarray(lengths), 8192,
                                             512, jax_reducer, lambda b: jnp.zeros((b,)),
                                             jax_mesh(2, 2), **kw)
    got, pnf, pfc = ptb.stft_reduce_sharded(*tensors(samples, lengths), 8192, 512, port_reducer,
                                            lambda b: None, port_mesh(2, 2), **kw)
    assert pnf == jnf
    np.testing.assert_array_equal(pfc.numpy(), np.asarray(jfc))
    e_want, e_got = np.asarray(want["e"]), got["e"].numpy()
    assert e_got.shape == e_want.shape == (2, pnf)
    floor = 1e-6 * e_want.max()
    np.testing.assert_allclose(e_got, e_want, rtol=1e-2, atol=floor)
    assert (e_want[0, :int(pfc[0])] > floor).mean() > 0.9  # the scale's frames carry energy


# --- the whole pipeline on a (tracks, time) mesh -----------------------------

KEY_OUTPUTS = ("key_idx", "key_confidence", "key_clarity", "confidence_key_confidence",
               "confidence_overall_confidence", "warn_low_key_confidence",
               "warn_low_key_clarity")


def test_full_pipeline_2d_mesh_matches_jax():
    """The default config on a (4, 2) mesh: every output the JAX package's
    2-D mesh gives, discrete ones exactly (the key STFT on both sides is the
    direct DFT that time blocks take). The 74 BPM track escalates: the port
    gathers its row and runs the hop-256 STFT in time blocks, where JAX runs
    the whole batch. Against the port's unsharded run on the same padded
    batch every output but the key's agrees too."""
    jcaps = JaxCaps(**PIPELINE_CAPS)
    tracks = [kick_pattern(bpm, secs) for bpm, secs in PIPELINE_TRACKS]
    samples, lengths = pad_batch(tracks)
    jm = jmesh.make_mesh(jax.devices()[:8], n_time=2)
    samples_p = jmesh.pad_batch_for_mesh(samples, jm)
    want = jmesh.analyze_batch_sharded(samples_p, lengths, JCFG, SR, jcaps, jm)
    want = {k: np.asarray(v) for k, v in want.items()}

    pm = port_mesh(4, 2)
    pcaps = port.PipelineCaps(**PIPELINE_CAPS)
    assert np.array_equal(pmesh.pad_batch_for_mesh(samples, pm), samples_p)
    got = pmesh.analyze_batch_sharded(samples_p, lengths, PCFG, SR, pcaps, pm)
    assert got["bpm"].device == CPU
    assert bool(got["multi_res_triggered"][0]), got["multi_res_triggered"]
    assert_outputs_match(want, got)

    unsharded = port.analyze_batch(samples_p, lengths, PCFG, SR, pcaps, device="cpu")
    assert_outputs_match({k: v for k, v in unsharded.items() if k not in KEY_OUTPUTS},
                         {k: v for k, v in got.items() if k not in KEY_OUTPUTS})


# --- the mesh API ------------------------------------------------------------

def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: make_mesh() finds it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()


def test_make_mesh_shapes_and_errors():
    m1 = pmesh.make_mesh([CPU] * 8)
    assert m1.shape == {"tracks": 8} and m1.axis_names == ("tracks",)
    m2 = pmesh.make_mesh([CPU] * 8, n_time=4)
    assert m2.shape == {"tracks": 2, "time": 4} and "time" in m2.shape
    assert m2.row(1).shape == {"tracks": 1, "time": 4}
    with pytest.raises(ValueError, match="not divisible by n_time=3"):
        pmesh.make_mesh([CPU] * 8, n_time=3)


@pytest.mark.parametrize("n_time", [1, 2, 4])
def test_pad_batch_for_mesh_matches_jax(rng, n_time):
    x = rng.standard_normal((2, 5000)).astype(np.float32)
    jm = jmesh.make_mesh(jax.devices()[:4], n_time=n_time)
    pm = pmesh.make_mesh([CPU] * 4, n_time=n_time)
    want = jmesh.pad_batch_for_mesh(x, jm)
    np.testing.assert_array_equal(pmesh.pad_batch_for_mesh(x, pm), want)
    np.testing.assert_array_equal(pmesh.pad_batch_for_mesh(torch.as_tensor(x), pm).numpy(), want)
    assert pmesh.TIME_QUANTUM == jmesh.TIME_QUANTUM
    np.testing.assert_array_equal(
        ptb.pad_to_time_multiple(torch.as_tensor(x), n_time, 512).numpy(),
        np.asarray(jtb.pad_to_time_multiple(jnp.asarray(x), n_time, 512)))


def _small():
    x = np.stack([kick_pattern(120.0, 3.0), kick_pattern(128.0, 3.0)])
    caps = port.PipelineCaps(max_onsets=128, max_beats=64, seg_beat_cap=16, max_segments=4)
    return x, np.full(2, x.shape[1]), caps


def test_analyze_batch_arrays_takes_a_mesh():
    """A 1-D mesh of two shards gives the unsharded outputs; a batch that
    does not divide over the tracks axis, a time axis on an unpadded T, and
    a device other than the mesh's first raise."""
    x, n, caps = _small()
    s, ln = tensors(x, n)
    want = port.analyze_batch(x, n, port.SLICE_CONFIG, SR, caps, device="cpu")
    got = port.analyze_batch_arrays(s, ln, port.SLICE_CONFIG, SR, caps, "",
                                    pmesh.make_mesh([CPU] * 2))
    assert_outputs_match(want, got)
    with pytest.raises(ValueError, match="does not divide over a tracks axis of 4"):
        pmesh.analyze_batch_sharded(x, n, port.SLICE_CONFIG, SR, caps, pmesh.make_mesh([CPU] * 4))
    with pytest.raises(ValueError, match="pad_batch_for_mesh"):
        pmesh.analyze_batch_sharded(x, n, port.SLICE_CONFIG, SR, caps,
                                    pmesh.make_mesh([CPU] * 4, n_time=2))
    with pytest.raises(ValueError, match="not the mesh's first device"):
        port.analyze_batch_arrays(s, ln, port.SLICE_CONFIG, SR, caps, "",
                                  pmesh.make_mesh([CPU] * 2), device="meta")


def test_dryrun_multichip_on_the_cpu(monkeypatch, capsys):
    """Both shardings of the multi-chip dry run, the 2-D one on 6 s tracks."""
    monkeypatch.setenv("DRYRUN_SECONDS", "6")
    pmesh.dryrun_multichip(4, device_type="cpu")
    out = capsys.readouterr().out
    assert "dryrun 1-D tracks mesh OK: 4 devices" in out
    assert "dryrun 2-D (tracks=2, time=2) mesh OK: 6s tracks" in out
    assert "family_ok=[ True" in out  # 168 BPM reads 166 in 6 s


def test_launch_counts_hold_under_threads():
    """Shards on distinct cards count launches from one host thread each:
    no increment may be lost."""
    def wrapper():
        pass

    wrapper.launches = 0
    n_threads, per_thread = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [cuda_build.count_launch(wrapper)
                                                    for _ in range(per_thread)])
                   for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == n_threads * per_thread
