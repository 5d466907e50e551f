"""The block layout of the port's (tracks, time) mesh on the CPU, without
JAX: ``parallel.timeblocks.TimeBlocks`` (each time position holds only its
own block of samples, a block's context comes from its neighbours' edges),
normalization and the trim shift block by block against the unsharded
functions, no allocation on any device as long as a whole row under five
configs, and the opt-in configs on a 2-D mesh against the unsharded run.
Meshes repeat ``torch.device("cpu")``.
"""

import numpy as np
import pytest
import torch

import stratum_dsp_tpu_torch as port
from stratum_dsp_tpu_torch import measure, testing
from stratum_dsp_tpu_torch.config import NormalizationMethod
from stratum_dsp_tpu_torch.features.key.pipeline import _key_halo, _key_stft_params
from stratum_dsp_tpu_torch.parallel import mesh as pmesh
from stratum_dsp_tpu_torch.parallel.timeblocks import TimeBlocks, frame_rms_sharded, time_blocks
from stratum_dsp_tpu_torch.preprocessing.normalization import normalize
from stratum_dsp_tpu_torch.preprocessing.silence import detect_and_trim

SR = 44100
CPU = torch.device("cpu")
CAPS = port.PipelineCaps(max_onsets=256, max_beats=256, seg_beat_cap=16, max_segments=6)
KEY_OUTPUTS = ("key_idx", "key_confidence", "key_clarity", "confidence_key_confidence",
               "confidence_overall_confidence", "warn_low_key_confidence",
               "warn_low_key_clarity")
# Two float32 sums of the same n <= 2**19 terms in two orders (one per row
# against one per block, then over the blocks) differ by at most about
# log2(n) = 19 roundings of PyTorch's pairwise reduction: 19 * 6e-8 ~ 1.2e-6
# relative; held to 1e-5 relative for the RMS and the gains that follow
# from sums, and to 1e-4 dB for the LUFS (10 log10(1 + 1e-5) = 4.3e-5 dB).
SUM_ORDER_RTOL = 1e-5
LUFS_DB_TOL = 1e-4


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def row_mesh(n_time: int) -> pmesh.Mesh:
    return pmesh.make_mesh([CPU] * n_time, n_time=n_time)


def whole(blocks: TimeBlocks) -> torch.Tensor:
    return torch.cat(blocks.blocks, dim=1)


def circular_slice(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Samples ``[lo, hi)`` of each row of the whole rows ``x [B, T]``,
    indices taken modulo T: what the JAX package's ``ppermute`` ring
    delivers to a block."""
    t = x.shape[1]
    return x[:, torch.arange(lo, hi) % t]


# --- the layout ----------------------------------------------------------------

@pytest.mark.parametrize("n_time", [2, 4])
def test_blocks_hold_their_samples_and_contexts_wrap_around(rng, n_time):
    """Built from numpy, each block holds exactly its own samples and no
    more; ``context`` is bit-equal to the circular slice of the whole rows,
    wrap-around included; a context longer than a block raises."""
    t = n_time * 8192
    x = rng.standard_normal((3, t)).astype(np.float32)
    blocks = TimeBlocks.from_samples(x, row_mesh(n_time))
    t_blk = t // n_time
    assert blocks.shape == (3, t) and blocks.t_blk == t_blk and blocks.n_time == n_time
    for j, b in enumerate(blocks.blocks):
        assert b.shape == (3, t_blk) and b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), x[:, j * t_blk:(j + 1) * t_blk])
    xt = torch.as_tensor(x)
    for left, right in ((0, 0), (1536, 0), (0, 1536), (1024, 7680), (t_blk, t_blk)):
        for j in range(n_time):
            got = blocks.context(j, left, right)
            want = circular_slice(xt, j * t_blk - left, (j + 1) * t_blk + right)
            assert torch.equal(got, want), (j, left, right)
    with pytest.raises(ValueError, match="cannot hold its neighbours' context"):
        blocks.context(0, t_blk + 1, 0)


def test_blocks_from_a_tensor_select_rows_and_split_shards(rng):
    """A CPU tensor cuts as numpy does; ``index_select`` takes the rows of
    every block; ``time_blocks`` gives one ``TimeBlocks`` a tracks shard,
    each on its own row of the mesh."""
    x = rng.standard_normal((4, 8192)).astype(np.float32)
    a = TimeBlocks.from_samples(torch.as_tensor(x), row_mesh(2))
    b = TimeBlocks.from_samples(x, row_mesh(2))
    assert all(torch.equal(p, q) for p, q in zip(a.blocks, b.blocks))
    idx = torch.tensor([3, 1])
    sel = a.index_select(0, idx)
    np.testing.assert_array_equal(whole(sel).numpy(), x[[3, 1]])
    shards = time_blocks(x, pmesh.make_mesh([CPU] * 4, n_time=2))
    assert [s.shape for s in shards] == [(2, 8192), (2, 8192)]
    np.testing.assert_array_equal(whole(shards[1]).numpy(), x[2:])


def test_frame_rms_from_blocks_equals_from_the_tensor(rng):
    """The frame RMS of a shard's blocks is bit for bit the one cut from the
    whole tensor (which tests/test_torch_parallel.py holds to JAX's)."""
    t = 65536
    x = (rng.standard_normal((2, t)) * 0.3).astype(np.float32)
    n = torch.tensor([t, 40001])
    m = row_mesh(4)
    want, want_n = frame_rms_sharded(torch.as_tensor(x), n, 2048, 1024, m)
    got, got_n = frame_rms_sharded(TimeBlocks.from_samples(x, m), n, 2048, 1024, m)
    assert torch.equal(got, want) and torch.equal(got_n, want_n)


# --- the trim shift, block by block ----------------------------------------------

T_TRIM = 4 * 16384  # four blocks of 16384 samples


def _trim_row(rng, lead: int, content: int) -> np.ndarray:
    row = np.zeros(T_TRIM, np.float32)
    row[lead:lead + content] = (rng.standard_normal(content) * 0.3).astype(np.float32)
    return row


TRIM_CASES = {
    # (leading silence, content, length) a row
    "lead-inside-a-block": [(5000, 40000, 60000), (0, 50000, 50000)],
    "lead-across-a-block-edge": [(20000, 30000, 64000), (0, 65536, 65536)],
    "lead-longer-than-a-block": [(40000, 20000, 65536), (3000, 9000, 30000)],
    "trailing-only": [(0, 30000, 65536), (0, 12000, 20000)],
    "no-silence": [(0, 65536, 65536), (0, 30000, 30000)],
    "an-all-silent-row": [(0, 0, 50000), (0, 40000, 40000)],
    "every-case": [(5000, 40000, 60000), (20000, 30000, 64000), (40000, 20000, 65536),
                   (0, 30000, 65536), (0, 65536, 65536), (0, 0, 50000)],
}


@pytest.mark.parametrize("case", sorted(TRIM_CASES))
def test_trim_shift_in_blocks_is_bit_equal_to_unsharded(rng, case):
    """Samples, lengths, trim_start, trim_end and all_silent equal the
    unsharded ``detect_and_trim`` bit for bit, whichever tier the batch
    takes (unchanged, masked, shifted)."""
    rows = TRIM_CASES[case]
    x = np.stack([_trim_row(rng, lead, content) for lead, content, _ in rows])
    n = torch.tensor([ln for _, _, ln in rows])
    m = row_mesh(4)
    want, want_n, want_info = detect_and_trim(torch.as_tensor(x), n, SR)
    blocks = TimeBlocks.from_samples(x, m)
    got, got_n, got_info = detect_and_trim(blocks, n, SR, mesh=m)
    assert isinstance(got, TimeBlocks) and [b.shape for b in got.blocks] == [(len(rows), 16384)] * 4
    assert torch.equal(whole(got), want)
    assert torch.equal(got_n, want_n)
    for k in ("trim_start", "trim_end", "all_silent"):
        assert torch.equal(got_info[k], want_info[k]), k
    if case == "no-silence":
        assert got is blocks  # the first tier: nothing trims, nothing moves
    if case == "every-case":
        assert (want_info["trim_start"] > 16384).any() and bool(want_info["all_silent"][-1])


# --- normalization, block by block ----------------------------------------------

@pytest.mark.parametrize("method", ["peak", "rms", "loudness"])
def test_normalize_in_blocks_matches_unsharded(rng, method):
    """PEAK: samples and gains bit for bit (a max is exact in any order).
    RMS and LOUDNESS: the gain, the samples and the RMS within
    SUM_ORDER_RTOL, the LUFS within LUFS_DB_TOL (the cross-block sums add in
    another order, ROADMAP.md Queue 3). Tracks of three lengths, one quiet,
    one silent, a block of 17 gating blocks and a piece."""
    t = 4 * 311296  # 7.06 s a block: gating blocks of 17640 samples straddle block edges
    x = np.zeros((4, t), np.float32)
    lengths = [t, 1000000, 500000, 300000]
    for i, (ln, amp) in enumerate(zip(lengths, (0.5, 0.05, 0.2, 0.0))):
        x[i, :ln] = np.sin(np.arange(ln) * 0.03) * amp + rng.standard_normal(ln) * amp * 0.1
    n = torch.tensor(lengths)
    meth = NormalizationMethod(method)
    want, want_meta = normalize(torch.as_tensor(x), n, meth, SR)
    got, got_meta = normalize(TimeBlocks.from_samples(x, row_mesh(4)), n, meth, SR)
    got_x = whole(got)
    assert got_x.shape == want.shape
    if method == "peak":
        assert torch.equal(got_x, want)
        for k in ("peak_db", "gain_db", "measured_lufs"):
            assert torch.equal(got_meta[k], want_meta[k]), k
    else:
        torch.testing.assert_close(got_x, want, rtol=SUM_ORDER_RTOL, atol=0.0)
        torch.testing.assert_close(10.0 ** (got_meta["gain_db"] / 20.0),
                                   10.0 ** (want_meta["gain_db"] / 20.0),
                                   rtol=SUM_ORDER_RTOL, atol=0.0)
        assert torch.equal(got_meta["peak_db"], want_meta["peak_db"])
        lufs_g, lufs_w = got_meta["measured_lufs"], want_meta["measured_lufs"]
        assert torch.equal(torch.isfinite(lufs_g), torch.isfinite(lufs_w))
        fin = torch.isfinite(lufs_w)
        torch.testing.assert_close(lufs_g[fin], lufs_w[fin], rtol=0.0, atol=LUFS_DB_TOL)
    fin = torch.isfinite(want_meta["rms_db"])
    assert torch.equal(torch.isfinite(got_meta["rms_db"]), fin)
    torch.testing.assert_close(got_meta["rms_db"][fin], want_meta["rms_db"][fin], rtol=0.0,
                               atol=LUFS_DB_TOL)


# --- no device holds a whole row -------------------------------------------------

def largest_context(cfg) -> int:
    """The longest context (left plus right) any block of ``cfg`` asks for:
    the key STFT's ``frame_size - hop`` and ``halo * hop`` on each side; the
    BPM STFT's 2 previous frames and ``2048 - 512``, the hop-256 pass's, the
    frame RMS's and the K-weighting FIR's 256 are all shorter."""
    frame_size, hop = _key_stft_params(cfg)
    return max(frame_size - hop + 2 * _key_halo(cfg) * hop,
               2 * cfg.hop_size + cfg.frame_size - cfg.hop_size)


def layout_batch():
    """~6 s: a 74 BPM kick (in the low trap: it escalates, and the
    percussive fallback looks at it) and 132 BPM kicks after 2 s of silence,
    which cross the first block edge at a time axis of 4."""
    late = np.concatenate([np.zeros(2 * SR, np.float32),
                           np.asarray(testing.kick_pattern(132.0, 4.5))])
    samples, lengths = testing.pad_batch([torch.as_tensor(testing.kick_pattern(74.0, 6.0)),
                                          torch.as_tensor(late)])
    return samples.numpy(), lengths.numpy()


LAYOUT_CONFIGS = {
    "default": port.AnalysisConfig(),
    "peak": port.AnalysisConfig(normalization=NormalizationMethod.PEAK),
    "rms": port.AnalysisConfig(normalization=NormalizationMethod.RMS),
    "loudness": port.AnalysisConfig(normalization=NormalizationMethod.LOUDNESS),
    "hpss": measure.opt_in_config("hpss"),
}


@pytest.mark.parametrize("n_time", [2, 4])
@pytest.mark.parametrize("config", sorted(LAYOUT_CONFIGS))
def test_no_allocation_holds_a_whole_row(config, n_time):
    """The whole pipeline on a (1, n_time) mesh from a numpy batch: no
    tensor any op allocates, on any device, has an axis longer than a block
    and its largest context (a whole row is 2 to 4 times that)."""
    cfg = LAYOUT_CONFIGS[config]
    x, n = layout_batch()
    mesh = row_mesh(n_time)
    x = pmesh.pad_batch_for_mesh(x, mesh)
    bound = x.shape[1] // n_time + largest_context(cfg)
    rec = testing.AllocationRecorder()
    with rec:
        out = pmesh.analyze_batch_sharded(x, n, cfg, SR, CAPS, mesh)
    print(f"{config} on (1, {n_time}): T = {x.shape[1]}, largest allocated axis "
          f"{rec.largest[0]} ({rec.largest[1]} {rec.largest[2]}), bound {bound}")
    assert rec.largest[0] <= bound < x.shape[1], rec.largest
    assert bool(out["ok"].all()) and abs(float(out["bpm"][1]) - 132.0) < 2.0, out["bpm"]
    assert abs(float(out["trim_start_seconds"][1]) - 2.0) < 0.05, out["trim_start_seconds"]


# --- the opt-in configs on a 2-D mesh against the unsharded run ------------------

@pytest.mark.parametrize("config", ["rms", "tuned-exact", "log-frequency", "hpss"])
def test_opt_in_configs_on_a_2d_mesh_match_unsharded(config):
    """On a (2, 2) mesh, every output but the key's (its STFT is the direct
    DFT under time blocks, tests/test_torch_parallel.py) equals the
    unsharded run on the same padded batch, discrete outputs exactly."""
    cfg = (LAYOUT_CONFIGS["rms"] if config == "rms" else measure.opt_in_config(config))
    x, n = layout_batch()
    mesh = pmesh.make_mesh([CPU] * 4, n_time=2)
    x = pmesh.pad_batch_for_mesh(x, mesh)
    got = pmesh.analyze_batch_sharded(x, n, cfg, SR, CAPS, mesh)
    want = port.analyze_batch(x, n, cfg, SR, CAPS, device="cpu")
    testing.assert_outputs_match({k: v for k, v in want.items() if k not in KEY_OUTPUTS},
                                 {k: v for k, v in got.items() if k not in KEY_OUTPUTS})
    if config == "hpss":
        assert bool(got["percussive_triggered"][0]), got["percussive_triggered"]
