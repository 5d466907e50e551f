"""Stage 1 of the polyphase key STFT (``ops/stft.py:poly_block_dft``, the
CUDA kernel ``csrc/poly_block_dft.cu`` and its plain version).

On the CPU: the wrapper's CPU path (and the f32 form) is the code before the
kernel bit for bit, the kernel's table read at the kernel's addresses is
``_poly_block_basis``, the counters, and the inputs the kernel refuses. On
the card (``cuda`` marker; they skip without one): the kernel against the
plain version at the main path's shapes, stage 2 on top of it, and one launch
a chunk. Imports no JAX, so that the ``cuda`` tests run on the card with the
conftest left out: ``python3 -m pytest --noconftest -p no:cacheprovider -m
cuda tests/test_torch_poly_block_dft.py``."""

import numpy as np
import pytest
import torch

import stratum_dsp_tpu_torch as port
from portbench.reference.plain.ops import stft as plain_stft
from stratum_dsp_tpu_torch import tracing
from stratum_dsp_tpu_torch.ops import polyphase, stft, tables

torch.set_num_threads(2)

N, HOP = 8192, 512


def _rows(seed: int, b: int, t: int) -> torch.Tensor:
    g = np.random.default_rng(seed)
    return torch.tensor(g.standard_normal((b, t)) * 0.3, dtype=torch.float32)


def _today(samples, start, ebp, n, hop, kp, bf16):
    """Stage 1 as ``polyphase_chunk_magnitudes`` computed it before the
    kernel."""
    blocks = samples[:, start * hop:(start + ebp) * hop].reshape(samples.shape[0], ebp, hop)
    basis = tables.on(samples.device, stft._poly_block_basis, n, hop, kp, bf16)
    bd = stft.bf16_matmul_f32(blocks, basis)
    return bd.to(torch.bfloat16) if bf16 else bd


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("b,start,ebp,n,hop,kp", [
    (2, 0, 240, N, HOP, 1024),
    (3, 32, 48, N, HOP, 4224),  # the log-frequency width, a non-zero start
    (1, 16, 64, 4096, 256, 128),
])
def test_cpu_and_f32_take_the_plain_path_bit_for_bit(bf16, b, start, ebp, n, hop, kp):
    x = _rows(1, b, (start + ebp + 1) * hop)
    got = stft.poly_block_dft(x, start, ebp, n, hop, kp, bf16)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert got.shape == (b, ebp, 2 * kp)
    assert torch.equal(got, _today(x, start, ebp, n, hop, kp, bf16))
    assert stft.poly_block_dft.launches == 0


@pytest.mark.parametrize("keep,start", [(931, 0), (4097, 16), (930, 48)])
def test_polyphase_chunk_magnitudes_equal_the_frozen_copy(keep, start):
    ext = 120
    ebp = stft.poly_num_blocks(ext, N, HOP)
    x = _rows(2, 2, (start + ebp + 1) * HOP)
    got = stft.polyphase_chunk_magnitudes(x, start, ext, N, HOP, keep)
    want = plain_stft.polyphase_chunk_magnitudes(x, start, ext, N, HOP, keep)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def _kernel_reads(table: torch.Tensor, n_cols: int, hop: int) -> torch.Tensor:
    """``[hop, n_cols]``: the table as the kernel reads it. Slab kb of column
    tile t holds column c = 256 t + r at rows 256 (t (hop / 64) + kb) + r of
    64 k each; its k = 64 kb + 8 q + e lies in chunk q at chunk position
    q ^ (r & 7), element e."""
    c = torch.arange(n_cols)[None, :]
    k = torch.arange(hop)[:, None]
    t, r = c // 256, c % 256
    kb, q, e = k // 64, (k % 64) // 8, k % 8
    flat = ((t * (hop // 64) + kb) * 256 + r) * 64 + (q ^ (r & 7)) * 8 + e
    return table[flat]


@pytest.mark.parametrize("n,hop,kp", [(N, HOP, 1024), (N, HOP, 4224), (4096, 256, 128),
                                      (16384, 1024, 256)])
def test_kernel_table_read_at_its_addresses_is_the_basis(n, hop, kp):
    table = tables.on("cpu", stft.poly_block_table, n, hop, kp)
    basis = tables.on("cpu", stft._poly_block_basis, n, hop, kp, True)
    assert table.dtype == torch.bfloat16 and table.is_contiguous()
    assert table.shape == (hop * 2 * kp,)
    assert torch.equal(_kernel_reads(table, 2 * kp, hop), basis)
    # column 5 (bin 5's cos), k = 8: slab 0, row 5, chunk 1 at 1 ^ 5 = 4, element 0
    assert table[5 * 64 + 4 * 8] == basis[8, 5]


def test_kernel_arithmetic_in_plain_pytorch_equals_the_plain_path():
    """The kernel's product written in PyTorch: the samples rounded to bf16,
    multiplied by the table as the kernel reads it, in another column and sum
    order; only the f32 sums' order differs from the plain path."""
    b, start, ebp, kp = 2, 16, 64, 1024
    x = _rows(3, b, (start + ebp + 1) * HOP)
    table = tables.on("cpu", stft.poly_block_table, N, HOP, kp)
    blocks = x[:, start * HOP:(start + ebp) * HOP].reshape(b, ebp, HOP).to(torch.bfloat16).float()
    cols = _kernel_reads(table, 2 * kp, HOP).float()
    got = sum(blocks[..., k0:k0 + 64] @ cols[k0:k0 + 64] for k0 in range(0, HOP, 64))
    want = stft.poly_block_dft_plain(x, start, ebp, N, HOP, kp)
    _assert_within_one_ulp(got.to(torch.bfloat16), want, blocks, cols)


def test_counters_count_every_polyphase_chunk():
    x = _rows(4, 2, 40 * 8192)
    lengths = torch.tensor([40 * 8192, 20 * 8192])
    port.reset_launch_counts()
    with tracing.recording(), tracing.span("key.stft"):
        _, nfp, _ = stft.stft_reduce(x, lengths, N, HOP, lambda s, i, v, c: ({"s": s[:, :1]}, c),
                                     lambda b: None, chunk_frames=128, halo=8, keep_bins=931,
                                     bf16=True)
    counts = tracing.counters()
    assert counts.get("poly_chunks") == nfp // 128 > 1
    assert "poly_block_dft" not in counts  # the CPU takes the plain path
    assert stft.poly_block_dft.launches == 0
    (rec,) = [r for r in tracing.spans() if r["name"] == "key.stft"]
    assert rec["counts"]["poly_chunks"] == nfp // 128
    port.reset_launch_counts()


def test_the_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        stft.poly_block_dft(torch.zeros((1, 64 * HOP), device="meta"), 0, 32, N, HOP, 1024)


@pytest.mark.parametrize("bad", ["f64", "strided", "hop", "kp", "past the end", "start"])
def test_kernel_input_checks(bad):
    x = torch.zeros((2, 50 * HOP))
    args = dict(start=0, ebp=48, hop=HOP, kp=1024)
    if bad == "f64":
        x = x.double()
    elif bad == "strided":
        x = torch.zeros((2, 100 * HOP))[:, ::2]
    elif bad == "hop":
        args["hop"] = 96
    elif bad == "kp":
        args["kp"] = 1000
    elif bad == "past the end":
        args["start"] = 3
    else:
        args["start"] = -1
    stft.check_poly_block_input(torch.zeros((2, 50 * HOP)), 0, 48, HOP, 1024)
    with pytest.raises(ValueError, match="poly_block_dft kernel"):
        stft.check_poly_block_input(x, **args)


def test_bound_at_the_main_path_shape():
    """A default key chunk: 20.1 GFLOP against 59 MB, at the ridge."""
    bound = stft.poly_block_dft_bound_ms(40, 240, HOP, 1024)
    assert bound["operations"] == 2 * 40 * 240 * 512 * 2048
    assert bound["bytes"] == 4 * 40 * 240 * 512 + 2 * 40 * 240 * 2048
    assert 0.017 < bound["bytes_ms"] < bound["operations_ms"] < 0.021


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp (8 significant bits) of each value."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def _assert_within_one_ulp(got, want, blocks, cols) -> dict:
    """Every element equal, or within one bf16 ulp of the larger of the two,
    or (near zero, where cancellation magnifies another sum order) within
    1e-6 of the largest the element could be, its block's norm times its
    column's. Returns the shares that differ and that need the last clause."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    scale = blocks.norm(dim=-1, keepdim=True) * cols.norm(dim=0)
    ulp_ok = d <= _bf16_ulp(torch.maximum(got.abs(), want.abs()))
    ok = ulp_ok | (d <= 1e-6 * scale)
    assert bool(ok.all()), float((d / scale)[~ok].max())
    return {"differ": float((d > 0).float().mean()), "near_zero": float((~ulp_ok).float().mean())}


# ---- on the card ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda:0")


CARD_CASES = [
    # b, start, ebp, kp, keep (stage 2's bins), offset (an unaligned row start)
    (40, 0, 240, 1024, 931, 0),  # a default key chunk
    (40, 0, 240, 4224, 4097, 0),  # the log-frequency width
    (16, 0, 512, 1024, 931, 0),  # the hpss cell's chunk
    (1, 0, 560, 1024, 931, 0),  # a single request
    (3, 48, 240, 1024, 931, 1),  # a later chunk, rows not 16-byte aligned
    (5, 16, 64, 4224, 4097, 3),  # a short chunk: most of the card idle
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,start,ebp,kp,keep,offset", CARD_CASES)
def test_kernel_against_plain_and_stage2_on_top(card, b, start, ebp, kp, keep, offset):
    x = _rows(5 + b, b, (start + ebp + 1) * HOP + 64).to(card)[:, offset:]
    before = stft.poly_block_dft.launches
    got = stft.poly_block_dft(x, start, ebp, N, HOP, kp)
    want = stft.poly_block_dft_plain(x, start, ebp, N, HOP, kp)
    torch.cuda.synchronize()
    assert stft.poly_block_dft.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    blocks = x[:, start * HOP:(start + ebp) * HOP].reshape(b, ebp, HOP).to(torch.bfloat16).float()
    cols = tables.on(card, stft._poly_block_basis, N, HOP, kp, True).float()
    shares = _assert_within_one_ulp(got, want, blocks, cols)
    print(f"[{b}, {ebp}, {2 * kp}] from block {start}: {shares}")
    # stage 2 on top stays within test_torch_polyphase.py's contract
    r, ext = N // HOP, ebp - 24  # the chunk's frames, as stft_reduce's halo of 12 gives them
    assert stft.poly_num_blocks(ext, N, HOP) == ebp
    mag = polyphase.polyphase_stage2(got, r, ext, keep).float()
    ref = polyphase.polyphase_stage2(want, r, ext, keep).float()
    scale = ref.amax(dim=-1, keepdim=True) + 1e-9
    assert float(((mag - ref).abs() / scale).max()) < 1e-2


@pytest.mark.cuda
def test_one_launch_a_chunk_on_the_card(card):
    x = _rows(6, 4, 400 * HOP).to(card)
    lengths = torch.tensor([400 * HOP, 300 * HOP, 9000, 390 * HOP], device=card)
    port.reset_launch_counts()
    with tracing.recording(), tracing.span("key.stft", device=card):
        _, nfp, _ = stft.stft_reduce(x, lengths, N, HOP, lambda s, i, v, c: ({"s": s[:, :1]}, c),
                                     lambda b: None, chunk_frames=192, halo=12, keep_bins=931,
                                     bf16=True)
    counts = tracing.counters()
    assert stft.poly_block_dft.launches == polyphase.polyphase_stage2.launches == nfp // 192
    assert counts["poly_block_dft"] == counts["poly_chunks"] == nfp // 192
    port.reset_launch_counts()
