"""The port's polyphase key STFT (``stratum_dsp_tpu_torch/ops/polyphase.py``
and ``ops/stft.py``) against the JAX package.

Stage 2 is the CUDA kernel on a card; on the CPU its plain PyTorch version
runs, and that is what these tests hold against the Pallas kernel in
interpret mode and against a float64 DFT. The kernel itself is compared with
the plain version on the card (``cuda`` marker; ``chip_smoke.py`` does the
same at the main path's shape).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stratum_dsp_tpu.ops import stft as jstft
from stratum_dsp_tpu.ops.polyphase_pallas import polyphase_stage2 as jax_stage2
from stratum_dsp_tpu_torch.ops import polyphase, stft

torch.set_num_threads(2)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp (8 significant bits) of each value."""
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 1e-30))) - 7)


def _random_bd(rng, b, ebp, kp):
    return (rng.standard_normal((b, ebp, 2 * kp)).astype(np.float32) * 4.0)


def test_plain_stage2_matches_pallas_interpret(rng):
    """Plain stage 2 vs the Pallas kernel (interpret mode) on the same bf16
    block DFTs, at the test_pallas_kernels shape (ext=120, keep=930): both
    round C to bf16, sum in f32 and round the output to bf16, so they agree
    to one bf16 ulp of each frame's maximum."""
    r, ext, keep = 16, 120, 930
    kp = -(-(keep + 1) // 128) * 128
    ebp = jstft.poly_num_blocks(ext, 8192, 512)
    bd = _random_bd(rng, 2, ebp, kp)
    bd_j = jnp.asarray(bd).astype(jnp.bfloat16)
    ref = np.asarray(jax_stage2(bd_j, r, ext, keep, interpret=True, out_bf16=True)
                     .astype(jnp.float32))
    got_t = polyphase.polyphase_stage2(torch.as_tensor(bd).to(torch.bfloat16), r, ext, keep)
    assert got_t.dtype == torch.bfloat16 and tuple(got_t.shape) == ref.shape
    got = got_t.float().numpy()
    frame_max = ref.max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - ref) <= _bf16_ulp(frame_max))


def test_polyphase_chunk_magnitudes_matches_jax_forced(rng, monkeypatch):
    """The port's polyphase_chunk_magnitudes (stage 1 matmul + stage 2) vs
    JAX's with STRATUM_FORCE_POLYPHASE / STRATUM_FORCE_PALLAS_POLY2 (the TPU
    path, Pallas in interpret mode). Stage 1 accumulates in a different
    order, which can move a bf16 rounding of the block DFTs by one ulp, so
    the bound is the TPU kernel's own contract (test_pallas_kernels.py:96):
    max |d| / frame max < 1e-2."""
    frame, hop, keep, ext, start = 8192, 512, 930, 120, 32
    ebp = jstft.poly_num_blocks(ext, frame, hop)
    x = (rng.standard_normal((2, (start + ebp + 1) * hop)) * 0.3).astype(np.float32)
    monkeypatch.setenv("STRATUM_FORCE_POLYPHASE", "1")
    monkeypatch.setenv("STRATUM_FORCE_PALLAS_POLY2", "1")
    jax.clear_caches()
    try:
        ref = np.asarray(jstft.polyphase_chunk_magnitudes(
            jnp.asarray(x), start, ext, frame, hop, keep).astype(jnp.float32))
    finally:
        monkeypatch.delenv("STRATUM_FORCE_POLYPHASE")
        monkeypatch.delenv("STRATUM_FORCE_PALLAS_POLY2")
        jax.clear_caches()
    got = stft.polyphase_chunk_magnitudes(torch.as_tensor(x), start, ext, frame, hop, keep)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    scale = ref.max(axis=-1, keepdims=True) + 1e-9
    assert np.max(np.abs(got.float().numpy() - ref) / scale) < 1e-2


def test_polyphase_f32_matches_periodic_hann_dft():
    """f32 form (no bf16 rounding) vs a float64 periodic-Hann DFT, with a
    non-R-aligned ext and a nonzero R-aligned start (test_stft.py:143)."""
    rng = np.random.default_rng(3)
    b, n, h, kb = 2, 2048, 128, 300
    ext, start = 53, 48
    x = rng.standard_normal((b, (start + stft.poly_num_blocks(ext, n, h) + 1) * h))
    x = x.astype(np.float32)
    mag = stft.polyphase_chunk_magnitudes(torch.as_tensor(x), start, ext, n, h, kb,
                                          bf16=False).numpy()
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)
    ref = np.zeros((b, ext, kb))
    for f in range(ext):
        fr = x[:, (start + f) * h:(start + f) * h + n].astype(np.float64) * w
        ref[:, f] = np.abs(np.fft.rfft(fr, axis=-1)[:, :kb])
    assert np.abs(mag - ref).max() < 2e-3 * max(np.abs(ref).max(), 1.0)


def test_stage2_tables_match_pallas_tables():
    """The twiddle table equals the Pallas kernel's float64-built table."""
    from stratum_dsp_tpu.ops.polyphase_pallas import _twiddle_tables

    r, kp = 16, 1024
    c, s = _twiddle_tables(r, kp, r)
    tab = polyphase.stage2_tables(r, "cpu").numpy()
    cls = (np.arange(r)[:, None] * (np.arange(kp)[None, :] % r)) % r
    np.testing.assert_array_equal(tab[0][cls], c[:, :kp])
    np.testing.assert_array_equal(tab[1][cls], s[:, :kp])


@pytest.mark.parametrize("b,ext,keep,kp", [(1, 5, 249, 256), (2, 65, 63, 128), (1, 40, 1, 128),
                                           (3, 64, 62, 128)],
                         ids=["ext-below-a-tile", "keep-past-a-warp-edge", "one-bin",
                              "keep-at-a-warp-edge"])
def test_plain_stage2_matches_pallas_interpret_ragged(rng, b, ext, keep, kp):
    """The shapes the CUDA kernel must also take (fewer frames than a frame
    tile, bins ending at and one past the 62 a warp writes and the 248 a
    block writes, column 0 alone): the plain version, which the kernel is
    held to bit for bit on the card, against the Pallas kernel in interpret
    mode, to one bf16 ulp of each frame's maximum."""
    r = 16
    ebp = -(-(ext + r) // r) * r
    bd = _random_bd(rng, b, ebp, kp)
    ref = np.asarray(jax_stage2(jnp.asarray(bd).astype(jnp.bfloat16), r, ext, keep,
                                interpret=True, out_bf16=True).astype(jnp.float32))
    bd_t = torch.as_tensor(bd).to(torch.bfloat16)
    polyphase.check_kernel_input(bd_t, r, ext, keep)
    got = polyphase.polyphase_stage2(bd_t, r, ext, keep).float().numpy()
    assert got.shape == ref.shape == (b, ext, keep)
    assert np.all(np.abs(got - ref) <= _bf16_ulp(ref.max(axis=-1, keepdims=True)))


def test_stage2_bound_at_the_main_path_shape():
    """Bytes and operations of one launch at [40, 240, 2048] -> [40, 216, 931]:
    the 231 rows x 932 columns of each half that feed an output, 34.4 MB,
    read once (not the 240 x 1024 the tensor holds) and 16.1 MB written once;
    bytes bound it. The byte and operation counts take the same rows and
    columns, and spare rows or padded columns do not move the bound."""
    bound = polyphase.bound_ms(40, 240, 1024, 16, 216, 931)
    assert bound["bytes"] == 2 * 40 * (231 * 2 * 932 + 216 * 931) == 50_534_400
    assert bound["operations"] == 40 * (8 * 231 * 932 + 216 * 931 * 51) == 479_129_280
    assert bound["bound_by"] == "bytes"
    assert bound["bound_ms"] == pytest.approx(50_534_400 / 3.35e12 * 1e3)
    assert bound["operations_ms"] == pytest.approx(479_129_280 / 67e12 * 1e3)
    assert polyphase.bound_ms(40, 272, 2048, 16, 216, 931) == bound
    assert polyphase.FRAME_TILE % polyphase.KERNEL_RATIO == 0


@pytest.mark.parametrize("bad", ["f32", "strided", "ext", "keep", "r"])
def test_stage2_kernel_input_checks(bad):
    """Input the kernel does not take is refused before any launch."""
    bd = torch.zeros((2, 144, 2048), dtype=torch.float32 if bad == "f32" else torch.bfloat16)
    if bad == "strided":
        bd = bd.transpose(0, 1)
    args = {"r": 16, "ext": 120, "keep_bins": 930}
    args.update({"ext": {"ext": 130}, "keep": {"keep_bins": 1024}, "r": {"r": 64}}.get(bad, {}))
    polyphase.check_kernel_input(torch.zeros((2, 144, 2048), dtype=torch.bfloat16), 16, 120, 930)
    with pytest.raises(ValueError):
        polyphase.check_kernel_input(bd, args["r"], args["ext"], args["keep_bins"])
    with pytest.raises(ValueError):
        polyphase.polyphase_stage2(bd.to("meta"), 16, 120, 930)  # no card, no fallback


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_stage2_kernel_matches_plain_on_card(cuda_device, rng):
    """The kernel rounds and sums in the plain version's order with no FMA
    contraction, so the two are bit-equal."""
    r, ext, keep = 16, 216, 931
    ebp = -(-(ext + r) // r) * r
    bd = torch.as_tensor(_random_bd(rng, 3, ebp, 1024), device=cuda_device).to(torch.bfloat16)
    before = polyphase.polyphase_stage2.launches
    got = polyphase.polyphase_stage2(bd, r, ext, keep)
    ref = polyphase.polyphase_stage2_plain(bd, r, ext, keep)
    assert polyphase.polyphase_stage2.launches == before + 1
    assert torch.equal(got, ref)


def test_log_frequency_width_is_inside_the_kernel_contract():
    """With ``enable_key_log_frequency`` every bin is kept: ``keep = 4097``,
    ``KP = 4224``. The kernel's input check admits that chunk."""
    bd = torch.zeros((2, 240, 2 * 4224), dtype=torch.bfloat16)
    polyphase.check_kernel_input(bd, 16, 216, 4097)
    assert polyphase.polyphase_stage2_plain(bd, 16, 216, 4097).shape == (2, 216, 4097)


@pytest.mark.cuda
def test_stage2_kernel_matches_plain_at_the_log_frequency_width_on_card(cuda_device, rng):
    r, ext, keep, kp = 16, 216, 4097, 4224
    ebp = -(-(ext + r) // r) * r
    bd = torch.as_tensor(_random_bd(rng, 2, ebp, kp), device=cuda_device).to(torch.bfloat16)
    assert torch.equal(polyphase.polyphase_stage2(bd, r, ext, keep),
                       polyphase.polyphase_stage2_plain(bd, r, ext, keep))
