"""Batched, chunked STFT frontend (port of ``stratum_dsp_tpu/ops/stft.py``).

Magnitudes of the Hann-windowed real DFT over a padded ``[B, T]`` batch,
streamed in frame chunks: each chunk's ``[B, C, K]`` magnitudes go straight
into a caller-provided reducer that emits small per-frame features, so the
full spectrogram never exists at once. Two forms, chosen as in the
reference:

* the direct windowed DFT, one matmul of the frames against a fused
  ``[n, 2K]`` cos|sin basis with the symmetric (n-1) Hann window folded in;
* the polyphase shared-block form for frame/hop ratios R >= 16 under the bf16
  pipeline (the 8192/512 key STFT): one per-hop-block DFT (stage 1,
  ``poly_block_dft``), then the stage-2 kernel (``ops/polyphase.py``) that
  twiddles, box-sums R blocks and applies the periodic-Hann 3-bin mix.

bf16 matmuls follow the reference's rounding points: operands rounded to
bf16, products accumulated in f32. PyTorch's bf16 ``matmul`` returns bf16, so
the plain versions upcast the rounded operands and multiply them in f32; on
a card each is one launch a chunk of a tensor-core kernel: the direct form
under a bf16 basis ``csrc/stft_magnitude.cu`` (``stft_magnitude``), stage 1
under bf16 ``csrc/poly_block_dft.cu`` (``poly_block_dft``).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from .. import tracing
from . import cuda_build, tables
from .polyphase import polyphase_stage2


def num_frames(n_samples: int, frame_size: int, hop: int) -> int:
    """Frame count for a signal of length n (extractor.rs:314)."""
    if n_samples < frame_size:
        return 0
    return (n_samples - frame_size) // hop + 1


def _hann_window_np(frame_size: int) -> np.ndarray:
    i = np.arange(frame_size, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / (frame_size - 1)))).astype(np.float32)


def hann_window(frame_size: int, device=None) -> torch.Tensor:
    """Hann window with the reference's (n-1) denominator (extractor.rs:318),
    shared (``ops/tables.py``)."""
    return tables.on(device, _hann_window_np, frame_size, site="stft.window")


def extract_frames(region: torch.Tensor, n_frames: int, frame_size: int, hop: int):
    """Overlapping frames ``[B, n_frames, frame_size]`` of ``region [B, L]``."""
    return region.unfold(-1, frame_size, hop)[:, :n_frames]


def _exact_phase(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """f32 angle 2*pi*((a*b) mod n)/n from an exact integer product."""
    return ((a * b) % n).to(torch.float32) * (2.0 * np.pi / n)


def fused_windowed_basis(n: int, window: torch.Tensor, keep_bins=None, bf16=False):
    """``[n, 2K]`` DFT basis with the window folded in: ``frames @ basis``
    gives ``[re | im]``. With ``bf16`` the basis is stored bf16."""
    k_bins = n // 2 + 1 if keep_bins is None else keep_bins
    dev = window.device
    phase = _exact_phase(torch.arange(n, device=dev)[:, None],
                         torch.arange(k_bins, device=dev)[None, :], n)
    fused = torch.cat([torch.cos(phase), torch.sin(phase)], dim=1) * window[:, None]
    return fused.to(torch.bfloat16) if bf16 else fused


def hann_basis(n: int, keep_bins, bf16: bool, device) -> torch.Tensor:
    """``fused_windowed_basis`` of the (n-1) Hann window on ``device``, made
    through ``ops/tables.py``."""
    return fused_windowed_basis(n, hann_window(n, device), keep_bins, bf16)


def bf16_matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with operands in ``w``'s dtype (bf16 or f32), accumulated
    and returned in f32."""
    if w.dtype == torch.bfloat16:
        x = x.to(torch.bfloat16).float()
        w = w.float()
    return torch.matmul(x, w)


def stft_magnitude_chunk(frames: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Windowed DFT magnitudes ``[B, C, K]`` (always f32) of frames [B, C, n]."""
    ri = bf16_matmul_f32(frames, basis)
    k = basis.shape[-1] // 2
    re, im = ri[..., :k], ri[..., k:]
    return torch.sqrt(re * re + im * im)


def stft_magnitude_plain(region: torch.Tensor, n_frames: int, hop: int, basis: torch.Tensor,
                         frame0: int, frame_counts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``stft_magnitude``: the frames unfolded, one
    matmul (``bf16_matmul_f32``), the magnitude and the frame mask."""
    spec = stft_magnitude_chunk(extract_frames(region, n_frames, basis.shape[0], hop), basis)
    fidx = frame0 + torch.arange(n_frames, device=region.device)
    fvalid = (fidx[None, :] >= 0) & (fidx[None, :] < frame_counts[:, None])
    return torch.where(fvalid[:, :, None], spec, 0.0)


MMA_TILE_COLS, MMA_SLAB_K = 256, 32  # the kernel's column tile and k-slab


def mma_swizzle(width: int) -> torch.Tensor:
    """``[width, 4]``: where row r of a kernel slab keeps its 16-byte chunk c
    (``c ^ ((r >> 1) & 3)``; the map is its own inverse)."""
    return torch.arange(4)[None, :] ^ ((torch.arange(width)[:, None] >> 1) & 3)


def mma_basis(n: int, keep_bins: int, device) -> torch.Tensor:
    """``hann_basis(n, keep_bins, bf16=True)`` in the kernel's layout, made
    through ``ops/tables.py``: the columns interleaved (column ``2 j`` bin j's
    cos column, ``2 j + 1`` its sin column) and zero-padded to a multiple of
    8, stored flat in the order the kernel streams them: each whole tile of
    256 columns as ``[n / 32, 256, 32]`` (a slab of 32 k a step), then the
    ragged last tile's columns as ``[n / 32, rows, 32]``, each row's four
    chunks of 8 k placed by ``mma_swizzle``."""
    basis = hann_basis(n, keep_bins, True, device)
    cols = torch.stack([basis[:, :keep_bins], basis[:, keep_bins:]], dim=2).reshape(n, -1).t()
    cols = F.pad(cols, (0, 0, 0, -(-2 * keep_bins // 8) * 8 - 2 * keep_bins))
    parts = []
    for tile in cols.split(MMA_TILE_COLS):
        rows = tile.shape[0]
        slabs = tile.reshape(rows, n // MMA_SLAB_K, 4, 8).transpose(0, 1)
        r = torch.arange(rows, device=cols.device)[:, None]
        parts.append(slabs[:, r, mma_swizzle(rows).to(cols.device)].reshape(-1))
    return torch.cat(parts)


def stft_magnitude_bound_ms(rows: int, frames: int, n: int, hop: int, keep_bins: int) -> dict:
    """The least time an H100 could take for one call on ``rows`` rows of
    ``frames`` frames of ``n`` samples at ``hop``.

    Bytes: each row's samples read once (f32), the ``[rows, frames, keep]``
    f32 magnitudes written once, over 3.35 TB/s. Operations: a multiply and
    an add a sample for each of the ``2 keep`` basis columns, over the 989
    TFLOP/s of dense bf16 on the tensor cores."""
    n_bytes = 4 * rows * ((frames - 1) * hop + n) + 4 * rows * frames * keep_bins
    n_ops = 2 * rows * frames * n * 2 * keep_bins
    return cuda_build.roofline(n_bytes, n_ops, ops_per_s=cuda_build.H100_BF16_OPS_PER_S)


def stft_magnitude(region: torch.Tensor, n_frames: int, hop: int, basis: torch.Tensor,
                   frame0: int, frame_counts: torch.Tensor) -> torch.Tensor:
    """Windowed DFT magnitudes ``[B, n_frames, K]`` f32 of the frames
    ``region[:, f * hop : f * hop + n]`` of ``region [B, L]`` against
    ``basis [n, 2K]`` (``hann_basis``), zero where ``frame0 + f`` lies outside
    ``[0, frame_counts[b])``. Counts one ``stft_chunks``.

    A CPU tensor or an f32 basis takes the plain version; a CUDA tensor under
    a bf16 basis launches the kernel (``csrc/stft_magnitude.cu``, one launch,
    counted as ``stft_kernel``) or raises."""
    tracing.count("stft_chunks")
    if region.device.type == "cpu" or basis.dtype != torch.bfloat16:
        return stft_magnitude_plain(region, n_frames, hop, basis, frame0, frame_counts)
    if region.device.type != "cuda":
        raise ValueError(f"stft_magnitude: unsupported device {region.device}")
    n, keep = basis.shape[0], basis.shape[1] // 2
    b, avail = region.shape
    if region.dtype != torch.float32 or region.stride(1) != 1:
        raise ValueError(f"stft_magnitude kernel takes f32 rows of unit stride, got "
                         f"{region.dtype} strides {region.stride()}")
    if n % 32 or hop % 16 or avail < (n_frames - 1) * hop + n or n_frames < 1:
        raise ValueError(f"stft_magnitude kernel: frames of {n} at hop {hop} (n a multiple of "
                         f"32, hop of 16), {n_frames} frames in {avail} samples")
    lib = cuda_build.library()
    if not lib.stratum_stft_magnitude_fits(n, hop):
        raise ValueError(f"stft_magnitude kernel: 32 frames of {n} at hop {hop} do not fit "
                         "in shared memory")
    table = tables.on(region.device, mma_basis, n, keep)
    counts = frame_counts.to(device=region.device, dtype=torch.int64).contiguous()
    out = torch.empty((b, n_frames, keep), dtype=torch.float32, device=region.device)
    with torch.cuda.device(region.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stratum_stft_magnitude(
            region.data_ptr(), region.stride(0), avail, table.data_ptr(), counts.data_ptr(),
            int(frame0), out.data_ptr(), b, n_frames, n, hop, keep, stream)
    cuda_build.check(rc, "stft_magnitude")
    tracing.count_launch(stft_magnitude)
    tracing.count("stft_kernel")
    return out


stft_magnitude.launches = 0


def _poly_block_basis(n: int, hop: int, kp: int, bf16: bool, device) -> torch.Tensor:
    """[hop, 2*KP] unwindowed DFT basis on the N-point grid, one hop block,
    made through ``ops/tables.py``."""
    phase = _exact_phase(torch.arange(hop, device=device)[:, None],
                         torch.arange(kp, device=device)[None, :], n)
    basis = torch.cat([torch.cos(phase), -torch.sin(phase)], dim=1)
    return basis.to(torch.bfloat16) if bf16 else basis


POLY_TILE_COLS, POLY_SLAB_K = 256, 64  # stage 1's column tile and k-slab


def poly_block_table(n: int, hop: int, kp: int, device) -> torch.Tensor:
    """``_poly_block_basis(n, hop, kp, bf16=True)`` in stage 1's kernel
    layout, made through ``ops/tables.py``: its ``2 kp`` columns in their own
    order, stored flat as ``[2 kp / 256, hop / 64, 256, 64]`` (a column tile's
    slabs of 64 k, one a step), each column r's eight chunks c of 8 k at
    ``c ^ (r & 7)``."""
    basis = tables.on(device, _poly_block_basis, n, hop, kp, True)
    tiles, slabs = 2 * kp // POLY_TILE_COLS, hop // POLY_SLAB_K
    cols = basis.t().reshape(tiles, POLY_TILE_COLS, slabs, 8, 8).transpose(1, 2)
    r = torch.arange(POLY_TILE_COLS, device=basis.device)[:, None]
    swizzle = torch.arange(8, device=basis.device)[None, :] ^ (r & 7)  # its own inverse
    return cols[:, :, r, swizzle].contiguous().reshape(-1)


def poly_block_dft_bound_ms(rows: int, ebp: int, hop: int, kp: int) -> dict:
    """The least time an H100 could take for one call of ``poly_block_dft``
    on ``rows`` rows of ``ebp`` blocks.

    Bytes: the blocks' f32 samples read once and the bf16 ``[rows, ebp, 2 kp]``
    written once, over 3.35 TB/s. Operations: a multiply and an add a sample
    for each of the ``2 kp`` columns, over the 989 TFLOP/s of dense bf16 on
    the tensor cores."""
    n_bytes = 4 * rows * ebp * hop + 2 * rows * ebp * 2 * kp
    n_ops = 2 * rows * ebp * hop * 2 * kp
    return cuda_build.roofline(n_bytes, n_ops, ops_per_s=cuda_build.H100_BF16_OPS_PER_S)


def poly_block_dft_plain(samples: torch.Tensor, start: int, ebp: int, n: int, hop: int, kp: int,
                         bf16: bool = True) -> torch.Tensor:
    """Plain PyTorch version of ``poly_block_dft``: the blocks sliced, one
    matmul (``bf16_matmul_f32``) and, under bf16, the cast."""
    blocks = samples[:, start * hop:(start + ebp) * hop].reshape(samples.shape[0], ebp, hop)
    bd = bf16_matmul_f32(blocks, tables.on(samples.device, _poly_block_basis, n, hop, kp, bf16))
    return bd.to(torch.bfloat16) if bf16 else bd


def check_poly_block_input(samples: torch.Tensor, start: int, ebp: int, hop: int,
                           kp: int) -> None:
    """Raise ``ValueError`` for input stage 1's kernel does not take."""
    if samples.dtype != torch.float32 or samples.dim() != 2 or samples.stride(1) != 1:
        raise ValueError(f"poly_block_dft kernel takes f32 rows of unit stride, got "
                         f"{samples.dtype} {tuple(samples.shape)} strides {samples.stride()}")
    if (hop % POLY_SLAB_K or kp % (POLY_TILE_COLS // 2) or start < 0 or ebp < 1
            or (start + ebp) * hop > samples.shape[1]):
        raise ValueError(f"poly_block_dft kernel: {ebp} blocks of {hop} (a multiple of "
                         f"{POLY_SLAB_K}) from block {start} in {samples.shape[1]} samples, "
                         f"kp {kp} (a multiple of {POLY_TILE_COLS // 2})")


def poly_block_dft(samples: torch.Tensor, start: int, ebp: int, n: int, hop: int, kp: int,
                   bf16: bool = True) -> torch.Tensor:
    """Stage 1 of the polyphase STFT: the DFT on the ``n``-point grid of
    each of the ``ebp`` hop blocks from block ``start`` of ``samples [B, T]``,
    ``[B, ebp, 2 kp]`` (re | im of bins ``< kp``; bf16 under ``bf16``, else
    f32), stage 2's input.

    A CPU tensor or the f32 form takes the plain version; a CUDA tensor under
    bf16 launches the kernel (``csrc/poly_block_dft.cu``, one launch, counted
    as ``poly_block_dft``) or raises."""
    if samples.device.type == "cpu" or not bf16:
        return poly_block_dft_plain(samples, start, ebp, n, hop, kp, bf16)
    if samples.device.type != "cuda":
        raise ValueError(f"poly_block_dft: unsupported device {samples.device}")
    check_poly_block_input(samples, start, ebp, hop, kp)
    lib = cuda_build.library()
    if not lib.stratum_poly_block_dft_fits(hop):
        raise ValueError(f"poly_block_dft kernel: 32 blocks of {hop} do not fit in shared memory")
    table = tables.on(samples.device, poly_block_table, n, hop, kp)
    out = torch.empty((samples.shape[0], ebp, 2 * kp), dtype=torch.bfloat16,
                      device=samples.device)
    with torch.cuda.device(samples.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stratum_poly_block_dft(samples[:, start * hop:].data_ptr(), samples.stride(0),
                                        table.data_ptr(), out.data_ptr(), samples.shape[0], ebp,
                                        hop, kp, stream)
    cuda_build.check(rc, "poly_block_dft")
    tracing.count_launch(poly_block_dft)
    tracing.count("poly_block_dft")
    return out


poly_block_dft.launches = 0


def poly_num_blocks(ext: int, frame_size: int, hop: int) -> int:
    """Blocks a polyphase chunk of ``ext`` frames consumes, rounded up to R."""
    r = frame_size // hop
    return -(-(ext + r) // r) * r


def polyphase_chunk_magnitudes(samples, start: int, ext: int, frame_size: int, hop: int,
                               keep_bins: int, bf16: bool = True) -> torch.Tensor:
    """Periodic-Hann STFT magnitudes ``[B, ext, keep_bins]`` for frames
    ``[start, start+ext)``; ``start`` must be a multiple of R. Stage 1 is
    ``poly_block_dft``; stage 2 is the kernel of ``ops/polyphase.py``. Counts
    one ``poly_chunks``."""
    tracing.count("poly_chunks")
    kp = -(-(keep_bins + 1) // 128) * 128  # bin keep_bins feeds the k+1 mix
    ebp = poly_num_blocks(ext, frame_size, hop)
    bd = poly_block_dft(samples, start, ebp, frame_size, hop, kp, bf16)
    return polyphase_stage2(bd, frame_size // hop, ext, keep_bins)


def use_polyphase(frame_size: int, hop: int, bf16: bool, keep_bins=None) -> bool:
    """The polyphase form is part of the bf16 pipeline (periodic vs symmetric
    Hann) and pays off when >= 16 frames share each block."""
    if not bf16 or frame_size % hop or hop % 128 or (frame_size // hop) < 16:
        return False
    kb = frame_size // 2 + 1 if keep_bins is None else keep_bins
    return -(-(kb + 1) // 128) * 128 <= frame_size


def stft_reduce(samples: torch.Tensor, lengths: torch.Tensor, frame_size: int, hop: int,
                reducer: Callable, carry_init: Callable, chunk_frames: int = 256,
                halo: int = 0, keep_bins=None, bf16: bool = False):
    """Stream the batched STFT in frame chunks through ``reducer``.

    ``reducer(spec, frame_idx, frame_valid, carry) -> (outs, carry)`` gets
    ``spec [B, C + 2*halo, K]`` for frames ``[c*C - halo, (c+1)*C + halo)``
    (out-of-range or beyond-track frames zeroed and marked invalid) and
    returns a dict of ``[B, C, ...]`` arrays for the central C frames.
    Returns ``(outs [B, n_chunks*C, ...], n_frames_padded, frame_counts)``.
    """
    b, t = samples.shape
    nf = max(num_frames(t, frame_size, hop), 1)
    kbins = keep_bins if keep_bins is not None else frame_size // 2 + 1
    poly = use_polyphase(frame_size, hop, bf16, kbins)
    if poly:
        r = frame_size // hop
        chunk_frames = -(-chunk_frames // r) * r  # chunk starts stay = 0 mod R
    n_chunks = -(-nf // chunk_frames)
    nf_padded = n_chunks * chunk_frames
    frame_counts = torch.where(lengths >= frame_size, (lengths - frame_size) // hop + 1, 0)
    ext = chunk_frames + 2 * halo

    # Left-pad by the halo so no chunk slice clamps (the first chunk's
    # central frames stay aligned with their labels, stft.py:482-501).
    lpad = halo * hop
    if poly:
        need = ((n_chunks - 1) * chunk_frames + poly_num_blocks(ext, frame_size, hop) + 1) * hop
    else:
        need = (nf_padded + 2 * halo - 1) * hop + frame_size
    samples = F.pad(samples, (lpad, max(need - (t + lpad), 0)))
    if not poly:
        basis = tables.on(samples.device, hann_basis, frame_size, keep_bins, bf16)

    arange_ext = torch.arange(ext, device=samples.device)
    carry = carry_init(b)
    chunks = []
    for c in range(n_chunks):
        s0 = c * chunk_frames
        fidx = s0 - halo + arange_ext
        fvalid = (fidx[None, :] >= 0) & (fidx[None, :] < frame_counts[:, None])
        if poly:
            spec = polyphase_chunk_magnitudes(samples, s0, ext, frame_size, hop, kbins)
            spec = torch.where(fvalid[:, :, None], spec, 0.0)
        else:
            region = samples[:, s0 * hop:s0 * hop + (ext - 1) * hop + frame_size]
            spec = stft_magnitude(region, ext, hop, basis, s0 - halo, frame_counts)
        outs, carry = reducer(spec, fidx, fvalid, carry)
        chunks.append(outs)
    outs = {k: torch.cat([o[k] for o in chunks], dim=1) for k in chunks[0]}
    return outs, nf_padded, frame_counts


def mel_filterbank_matrix(sample_rate: int, n_bins: int, n_mels: int, fmin_hz: float,
                          fmax_hz: float) -> np.ndarray:
    """HTK-mel triangular filterbank ``[n_bins, n_mels]`` with the reference's
    integer-bin triangles (novelty.rs:78-172)."""
    if sample_rate <= 0 or n_bins < 2:
        raise ValueError("invalid mel filterbank params")
    n_mels = max(n_mels, 4)
    nyquist = sample_rate * 0.5
    fmin = min(max(fmin_hz, 0.0), max(nyquist, 1.0))
    fmax = fmax_hz if (np.isfinite(fmax_hz) and fmax_hz > 0.0) else nyquist
    fmax = float(np.clip(fmax, fmin + 1.0, nyquist))
    freq_res = sample_rate / ((n_bins - 1) * 2)

    def mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def inv_mel(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mel_min, mel_max = mel(fmin), mel(fmax)
    step = (mel_max - mel_min) / (n_mels + 1)
    hz_points = inv_mel(mel_min + step * np.arange(n_mels + 2))
    bin_points = np.clip(np.round(hz_points / freq_res).astype(np.int64), 0, n_bins - 1)
    for i in range(1, len(bin_points)):
        if bin_points[i] <= bin_points[i - 1]:
            bin_points[i] = min(bin_points[i - 1] + 1, n_bins - 1)

    w = np.zeros((n_bins, n_mels), dtype=np.float32)
    for m in range(n_mels):
        left, center, right = bin_points[m], bin_points[m + 1], bin_points[m + 2]
        if not (left < center < right):
            continue
        for bb in range(left + 1, center + 1):
            w[bb, m] += (bb - left) / (center - left)
        for bb in range(center, right):
            w[bb, m] += (right - bb) / (right - center)
    return w


@functools.lru_cache(maxsize=64)
def hz_to_bin(freq_hz: float, freq_resolution: float, n_bins: int) -> int:
    """Rounded, clamped Hz -> bin conversion (tempogram.rs:279-289)."""
    if not np.isfinite(freq_hz) or freq_hz <= 0.0 or freq_resolution <= 0.0:
        return 0
    return int(np.clip(round(freq_hz / freq_resolution), 0, max(n_bins - 1, 0)))
