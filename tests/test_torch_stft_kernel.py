"""The direct windowed DFT's magnitudes (``ops/stft.py:stft_magnitude``, the
CUDA kernel ``csrc/stft_magnitude.cu`` and its plain version).

On the CPU: the wrapper's dispatch (a CPU tensor, or an f32 basis, gives the
plain path bit for bit, and ``stft_reduce`` equals the benchmark's frozen copy
of the port before the kernel, ``portbench/reference``), the kernel's basis
layout and frame addressing written as plain PyTorch against the plain path,
and the counters. On the card (``cuda`` marker; they skip without one): the
kernel against the plain path and against an f64 DFT of the same
bf16-rounded operands at the shapes of every caller, and one launch a chunk.
Imports no JAX, so that the ``cuda`` tests run on the card with the conftest
left out: ``python3 -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_stft_kernel.py``."""

import numpy as np
import pytest
import torch

import stratum_dsp_tpu_torch as port
from portbench.reference.plain.ops import stft as plain_stft
from stratum_dsp_tpu_torch import tracing
from stratum_dsp_tpu_torch.ops import stft, tables

torch.set_num_threads(2)

PAD = 8  # bf16 the kernel leaves free after every hop samples of its span


def _rows(seed: int, b: int, t: int) -> torch.Tensor:
    g = np.random.default_rng(seed)
    return torch.tensor(g.standard_normal((b, t)) * 0.3, dtype=torch.float32)


def _today(region, n_frames, hop, basis, frame0, counts):
    """The chunk as ``stft_reduce`` computed it before the kernel."""
    spec = stft.stft_magnitude_chunk(stft.extract_frames(region, n_frames, basis.shape[0], hop),
                                     basis)
    fidx = frame0 + torch.arange(n_frames)
    fvalid = (fidx[None, :] >= 0) & (fidx[None, :] < counts[:, None])
    return torch.where(fvalid[:, :, None], spec, 0.0)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("n,hop,keep,frame0,counts", [
    (2048, 512, None, 0, [40, 17, 0]),
    (2048, 256, None, -3, [40, 40, 2]),  # a halo before the row's first frame
    (512, 128, 200, 30, [35, 40, 31]),  # past some rows' ends
])
def test_cpu_and_f32_basis_take_the_plain_path_bit_for_bit(bf16, n, hop, keep, frame0, counts):
    basis = tables.on("cpu", stft.hann_basis, n, keep, bf16)
    x = _rows(1, 3, 39 * hop + n)
    fc = torch.tensor(counts)
    got = stft.stft_magnitude(x, 40, hop, basis, frame0, fc)
    assert got.dtype == torch.float32
    assert torch.equal(got, _today(x, 40, hop, basis, frame0, fc))
    assert stft.stft_magnitude.launches == 0


@pytest.mark.parametrize("bf16,halo,keep", [(True, 0, None), (True, 2, 300), (False, 1, None)])
def test_stft_reduce_equals_the_frozen_copy(bf16, halo, keep):
    n, hop = 1024, 256
    x = _rows(2, 3, 150 * hop)
    lengths = torch.tensor([150 * hop, 61 * hop + 17, 700])  # the last shorter than a frame

    def reducer(spec, fidx, fvalid, carry):
        return {"spec": spec, "valid": fvalid}, carry

    got = stft.stft_reduce(x, lengths, n, hop, reducer, lambda b: None, chunk_frames=64,
                           halo=halo, keep_bins=keep, bf16=bf16)
    want = plain_stft.stft_reduce(x, lengths, n, hop, reducer, lambda b: None, chunk_frames=64,
                                  halo=halo, keep_bins=keep, bf16=bf16)
    for k in ("spec", "valid"):
        assert torch.equal(got[0][k], want[0][k])
    assert got[1] == want[1] and torch.equal(got[2], want[2])


@pytest.mark.parametrize("n,keep", [(2048, 1025), (8192, 931), (256, 7)])
def test_mma_basis_is_the_plain_basis_in_pairs(n, keep):
    basis = tables.on("cpu", stft.hann_basis, n, None if keep == n // 2 + 1 else keep, True)
    mb = tables.on("cpu", stft.mma_basis, n, keep)
    width = -(-2 * keep // 8) * 8
    assert mb.dtype == torch.bfloat16 and mb.is_contiguous() and mb.shape == (width * n,)
    # column 5 (bin 2's sin), k = n - 1: in slab n / 32 - 1 of tile 0, row 5,
    # chunk 3 at position 3 ^ ((5 >> 1) & 3) = 1, element 7
    if width >= 256:
        assert mb[((n // 32 - 1) * 256 + 5) * 32 + 8 * 1 + 7] == basis[n - 1, keep + 2]
    mb = _columns(mb, n, width)
    assert torch.equal(mb[0:2 * keep:2].t(), basis[:, :keep])
    assert torch.equal(mb[1:2 * keep:2].t(), basis[:, keep:])
    assert not mb[2 * keep:].any()


def _columns(table: torch.Tensor, n: int, width: int) -> torch.Tensor:
    """The kernel's flat table (whole 256-column tiles, then the ragged one,
    each ``[n / 32, rows, 32]`` with swizzled chunks) as columns
    ``[width, n]``."""
    out = []
    for part in table.split(256 * n):
        rows = part.numel() // n
        slabs = part.reshape(n // 32, rows, 4, 8)[:, torch.arange(rows)[:, None],
                                                  stft.mma_swizzle(rows)]
        out.append(slabs.reshape(n // 32, rows, 32).transpose(0, 1).reshape(rows, n))
    assert sum(o.shape[0] for o in out) == width
    return torch.cat(out)


def _kernel_model(region, n_frames, n, hop, frame0, counts, keep, bm=128):
    """The kernel's arithmetic in plain PyTorch: each block of ``bm`` frames
    of a row loads its span of samples rounded to bf16 with ``PAD`` free
    after every ``hop``, reads frame f's sample k at
    ``f (hop + PAD) + k + PAD (k // hop)``, multiplies by the interleaved
    table (``mma_basis``) and takes each bin's magnitude from its pair of
    columns."""
    b, avail = region.shape
    width = -(-2 * keep // 8) * 8
    table = _columns(tables.on("cpu", stft.mma_basis, n, keep), n, width).float()
    out = torch.zeros((b, n_frames, keep))
    k = torch.arange(n)[None, :]
    for row in range(b):
        for f0 in range(0, n_frames, bm):
            length = (bm - 1) * hop + n
            i = torch.arange(length)
            vals = torch.zeros(length)
            ok = f0 * hop + i < avail
            vals[ok] = region[row, f0 * hop + i[ok]]
            span = torch.zeros(int(length + PAD * ((length - 1) // hop) + 1), dtype=torch.bfloat16)
            span[i + PAD * (i // hop)] = vals.to(torch.bfloat16)
            f = torch.arange(min(bm, n_frames - f0))[:, None]
            frames = span[f * (hop + PAD) + k + PAD * (k // hop)].float()
            cols = frames @ table.t()
            re, im = cols[:, 0:2 * keep:2], cols[:, 1:2 * keep:2]
            out[row, f0:f0 + f.shape[0]] = torch.sqrt(re * re + im * im)
    fidx = frame0 + torch.arange(n_frames)
    fvalid = (fidx[None, :] >= 0) & (fidx[None, :] < counts[:, None])
    return torch.where(fvalid[:, :, None], out, 0.0)


@pytest.mark.parametrize("n,hop,keep,n_frames,frame0,counts", [
    (2048, 512, 1025, 140, -2, [200, 100, 0]),  # two frame tiles, a halo, a short row
    (2048, 256, 1025, 130, 5, [60, 200, 135]),
    (1024, 512, 300, 40, 0, [40, 40, 40]),
])
def test_kernel_addressing_and_layout_equal_the_plain_path(n, hop, keep, n_frames, frame0, counts):
    basis = tables.on("cpu", stft.hann_basis, n, keep, True)
    x = _rows(3, 3, (n_frames - 1) * hop + n)
    fc = torch.tensor(counts)
    want = stft.stft_magnitude_plain(x, n_frames, hop, basis, frame0, fc)
    got = _kernel_model(x, n_frames, n, hop, frame0, fc, keep)
    # only the order of the f32 sums differs (another column order in the product)
    scale = want.abs().max()
    torch.testing.assert_close(got, want, rtol=0, atol=float(2e-6 * scale))
    assert torch.equal(got == 0, want == 0)


def test_counters_count_every_direct_chunk():
    n, hop = 1024, 256
    x = _rows(4, 2, 100 * hop)
    lengths = torch.tensor([100 * hop, 40 * hop])
    port.reset_launch_counts()
    with tracing.recording(), tracing.span("bpm_features"):
        _, nfp, _ = stft.stft_reduce(x, lengths, n, hop, lambda s, i, v, c: ({"s": s}, c),
                                     lambda b: None, chunk_frames=32, bf16=True)
    counts = tracing.counters()
    assert counts.get("stft_chunks") == nfp // 32
    assert "stft_kernel" not in counts  # the CPU takes the plain path
    (rec,) = [r for r in tracing.spans() if r["name"] == "bpm_features"]
    assert rec["counts"]["stft_chunks"] == nfp // 32
    port.reset_launch_counts()


def test_the_wrapper_refuses_other_devices():
    basis = tables.on("cpu", stft.hann_basis, 256, None, True)
    with pytest.raises(ValueError, match="unsupported device"):
        stft.stft_magnitude(torch.zeros((1, 1024), device="meta"), 4, 128, basis, 0,
                            torch.ones(1, dtype=torch.int64))


# ---- on the card ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda:0")


def _f64_magnitudes(region, n_frames, hop, basis, frame0, counts):
    """The DFT of the same bf16-rounded operands in f64, masked."""
    n = basis.shape[0]
    frames = stft.extract_frames(region, n_frames, n, hop).to(torch.bfloat16).double()
    ri = frames @ basis.double()
    k = basis.shape[1] // 2
    mag = torch.sqrt(ri[..., :k] ** 2 + ri[..., k:] ** 2)
    fidx = frame0 + torch.arange(n_frames, device=region.device)
    fvalid = (fidx[None, :] >= 0) & (fidx[None, :] < counts[:, None])
    return torch.where(fvalid[:, :, None], mag, 0.0), frames


CARD_CASES = [
    # b, n, hop, keep, frames, frame0, counts (None: every frame counts)
    (40, 2048, 512, None, 256, 0, None),  # the base BPM pass
    (12, 2048, 256, None, 256, 512, None),  # the hop-256 escalation
    (16, 2048, 512, None, 256, 0, None),  # the HPSS spectrogram
    (1, 2048, 512, None, 256, 0, None),  # a single request
    (40, 8192, 512, 931, 16, -2, None),  # the 2-D mesh's key STFT, a halo
    (12, 2048, 256, None, 260, -2, "ragged"),  # halo, rows ending inside the chunk
    (16, 2048, 512, None, 256, 15000, "past"),  # the last chunk past every row's end
    (3, 2048, 512, None, 100, 0, "zero"),  # rows shorter than a frame
    (4, 256, 64, 60, 100, 0, None),  # a ragged tile of 120 columns in eight rounds
    (6, 1024, 256, 300, 70, -1, "ragged"),  # a ragged tile too large for the stages
]


def _counts(kind, b, frame0, frames, device):
    g = np.random.default_rng(b)
    if kind is None:
        vals = np.full(b, frame0 + frames + 10)
    elif kind == "ragged":
        vals = frame0 + g.integers(0, frames + 5, b)
    elif kind == "past":
        vals = np.full(b, frame0 - 1)
    else:
        vals = np.zeros(b, np.int64)
    return torch.tensor(vals, dtype=torch.int64, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,hop,keep,frames,frame0,kind", CARD_CASES)
def test_kernel_against_plain_and_f64(card, b, n, hop, keep, frames, frame0, kind):
    basis = tables.on(card, stft.hann_basis, n, keep, True)
    x = _rows(5 + b, b, (frames - 1) * hop + n + 300).to(card)
    region = x[:, 100:100 + (frames - 1) * hop + n]  # unaligned rows of a wider tensor
    fc = _counts(kind, b, frame0, frames, card)
    got = stft.stft_magnitude(region, frames, hop, basis, frame0, fc)
    plain = stft.stft_magnitude_plain(region, frames, hop, basis, frame0, fc)
    exact, bf_frames = _f64_magnitudes(region, frames, hop, basis, frame0, fc)
    torch.cuda.synchronize()
    assert got.shape == plain.shape and got.dtype == torch.float32
    assert torch.equal(got == 0, plain == 0)
    err_k = (got.double() - exact).abs().amax(dim=-1)
    err_p = (plain.double() - exact).abs().amax(dim=-1)
    w = stft.hann_window(n, card)
    energy = bf_frames.norm(dim=-1) * w.double().norm()
    assert bool((err_k <= 4 * err_p + 1e-6 * energy).all()), float((err_k - 4 * err_p).max())


@pytest.mark.cuda
def test_one_launch_a_chunk_on_the_card(card):
    n, hop = 2048, 512
    x = _rows(6, 4, 700 * hop).to(card)
    lengths = torch.tensor([700 * hop, 300 * hop, 1000, 650 * hop], device=card)
    port.reset_launch_counts()
    with tracing.recording(), tracing.span("bpm_features", device=card):
        _, nfp, _ = stft.stft_reduce(x, lengths, n, hop, lambda s, i, v, c: ({"s": s}, c),
                                     lambda b: None, chunk_frames=256, bf16=True)
    counts = tracing.counters()
    assert stft.stft_magnitude.launches == nfp // 256
    assert counts["stft_kernel"] == counts["stft_chunks"] == nfp // 256
    port.reset_launch_counts()
