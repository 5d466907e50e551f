"""The windowed-median kernel (``csrc/window_median.cu``, wrapped by
``stratum_dsp_tpu_torch/ops/masked.py:window_median``) against its plain
version on the card (``cuda`` marker; they skip without one).

Every output of both is a selection from the input, or one f32 mean of two
selections, so they are held equal with ``torch.equal``: at the HPSS cell's
shape on both axes, at the chroma smoothing's shape, on ties and zeros at
every half-width the register path and the general path take, and through a
whole ``hpss_decompose``. This file imports no JAX, so it runs on the card's
machine: ``python3 -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_window_median.py``.
"""

import pytest
import torch

from stratum_dsp_tpu_torch.features.chroma import extractor
from stratum_dsp_tpu_torch.features.onset import hpss
from stratum_dsp_tpu_torch.ops import masked

# the HPSS cell: 16 tracks of 180 s, 2048 / 512 frames, 1025 bins
CELL_SHAPE = (16, 15500, 1025)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda:0")


def _ties(gen, shape, dev, zeros=0.3):
    """Few distinct values (many ties) and a share of exact zeros."""
    x = torch.randint(0, 5, shape, generator=gen, device=dev).to(torch.float32) * 0.25
    return torch.where(torch.rand(shape, generator=gen, device=dev) < zeros, 0.0, x)


def _both(x, nv, half, average_even, dim):
    before = masked.window_median.launches
    got = masked.window_median(x, nv, half, average_even, dim)
    torch.cuda.synchronize()
    assert masked.window_median.launches == before + 1
    return got, masked.window_median_plain(x, nv, half, average_even, dim)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [1, 2])
def test_kernel_equals_plain_at_the_hpss_cell_shape(dev, dim):
    """Both passes of an HPSS iteration on the cell's [16, 15500, 1025]
    magnitudes: the time axis with the cell's frame counts (every track
    180 s), the frequency axis whole."""
    gen = torch.Generator(device=dev).manual_seed(14)
    x = torch.rand(CELL_SHAPE, generator=gen, device=dev) * 3.0
    counts = torch.full((CELL_SHAPE[0],), CELL_SHAPE[1], device=dev)
    nv = counts if dim == 1 else None
    got, ref = _both(x, nv, 10, True, dim)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_kernel_equals_plain_at_the_chroma_shape(dev):
    """The key path's smoothing: window 5, element count // 2, ragged frames."""
    gen = torch.Generator(device=dev).manual_seed(15)
    x = torch.rand((40, 3900, 12), generator=gen, device=dev)
    n_frames = torch.randint(0, 3901, (40,), generator=gen, device=dev)
    n_frames[:4] = torch.tensor([0, 1, 5, 3900])
    got, ref = _both(x, n_frames, 2, False, 1)
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("half", [0, 1, 2, 8, 10, masked.MEDIAN_REGISTER_HALF,
                                  masked.MEDIAN_REGISTER_HALF + 1, 40])
@pytest.mark.parametrize("average_even", [True, False])
@pytest.mark.parametrize("shape, dim", [((5, 300, 70), 1), ((5, 70, 300), 2), ((3, 7, 1), 1),
                                        ((301,), 0)])
def test_kernel_equals_plain_on_ties_and_zeros(dev, half, average_even, shape, dim):
    """Ragged valid lengths (0, 1, 2, odd, even, whole, past the axis) on
    both layouts, a column count that is not a multiple of 32, a row count
    that is not one either, an axis shorter than the window."""
    gen = torch.Generator(device=dev).manual_seed(16 + half)
    x = _ties(gen, shape, dev)
    n = shape[dim]
    lead = shape[:dim]
    nv = None
    if lead:
        nv = torch.randint(0, n + 1, lead, generator=gen, device=dev)
        fixed = torch.tensor([0, 1, 2, n, n + 5][:lead[0]], device=dev)
        nv.view(lead[0], -1)[:len(fixed), 0] = fixed
    got, ref = _both(x, nv, half, average_even, dim)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_hpss_decompose_equals_the_plain_medians_and_counts_its_launches(dev, monkeypatch):
    """A whole decomposition, ragged frame counts: every median a launch,
    two an iteration, and the same harmonic and percussive parts as with
    the plain medians on the card."""
    gen = torch.Generator(device=dev).manual_seed(17)
    spec = torch.rand((4, 2000, 1025), generator=gen, device=dev) * 2.0
    counts = torch.tensor([2000, 1500, 11, 0], device=dev)
    spec[1, 1500:] = 0.0
    spec[2, 11:] = 0.0
    spec[3] = 0.0
    before = masked.window_median.launches
    got = hpss.hpss_decompose(spec, counts, 10)
    torch.cuda.synchronize()
    assert masked.window_median.launches == before + 2 * hpss.DEFAULT_ITERATIONS
    monkeypatch.setattr(masked, "window_median", masked.window_median_plain)
    ref = hpss.hpss_decompose(spec, counts, 10)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_key_hpss_mask_equals_the_plain_medians(dev, monkeypatch, dtype):
    """The key path's HPSS mask (half 8 on both axes of the downsampled band
    spectrogram, which the key STFT gives in bf16): two launches, and the
    same mask as with the plain medians on the card."""
    gen = torch.Generator(device=dev).manual_seed(18)
    band = (torch.rand((6, 900, 300), generator=gen, device=dev) * 2.0).to(dtype)
    counts = torch.tensor([900, 450, 17, 1, 0, 899], device=dev)
    before = masked.window_median.launches
    got = extractor.hpss_median_mask_downsampled(band, counts, 8, 8, 2.0)
    torch.cuda.synchronize()
    assert masked.window_median.launches == before + 2
    monkeypatch.setattr(masked, "window_median", masked.window_median_plain)
    assert got.dtype == dtype
    assert torch.equal(got, extractor.hpss_median_mask_downsampled(band, counts, 8, 8, 2.0))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(dev):
    x = torch.rand((2, 50, 40), device=dev)
    with pytest.raises(ValueError, match="f32"):
        masked.window_median(x.double(), None, 3, True, 1)
    with pytest.raises(ValueError, match="contiguous"):
        masked.window_median(x.transpose(1, 2), None, 3, True, 1)
