"""Stage 2 of the polyphase key STFT: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of the Pallas TPU kernel ``stratum_dsp_tpu/ops/polyphase_pallas.py``
(``polyphase_stage2``). Given the per-hop-block DFTs ``bd [B, EBP, 2*KP]`` of
an R-aligned chunk, it computes, for frames f < ext and bins k < keep_bins:

    C[j, k] = e^{-2 pi i k j / R} Bd[j, k]
    S[f, k] = sum_{j=f}^{f+R-1} C[j, k]
    |0.5 S[k] - 0.25 (e^{-i phi} S[k-1] + e^{+i phi} S[k+1])|,  phi = 2 pi (f mod R) / R

(the periodic-Hann 3-bin mix with the untwiddle folded in, S[-1] = conj S[1]).
With bf16 ``bd`` (the pipeline's path) C is rounded to bf16, S accumulates in
f32 and the output is bf16, the rounding points of the TPU kernel; with f32
``bd`` nothing is rounded (the reference's f32 formulation).

Dispatch goes by the input's device: a CPU tensor takes the plain version, a
CUDA tensor launches ``csrc/polyphase_stage2.cu`` or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from . import cuda_build, tables

KERNEL_RATIO = 16  # the frame/hop ratio R the CUDA kernel is instantiated for
FRAME_TILE = 64  # frames per CUDA block, a multiple of R (its R-1 halo rows come from L2)


def _twiddles(r: int) -> np.ndarray:
    ang = 2.0 * np.pi * np.arange(r) / r
    return np.stack([np.cos(ang), -np.sin(ang)]).astype(np.float32)


def stage2_tables(r: int, device) -> torch.Tensor:
    """``[4, R]`` f32 tables: twiddle cos and -sin of 2*pi*m/R (float64 on the
    host, as the TPU kernel's ``_twiddle_tables``), then the per-frame mix
    phase cos/sin of f32 ``m * (2*pi/R)`` (as its in-kernel iota), made
    through ``ops/tables.py``."""
    tw = tables.on(device, _twiddles, r, site="polyphase.twiddles")
    phi = torch.arange(r, device=device).to(torch.float32) * (2.0 * np.pi / r)
    return torch.cat([tw, torch.stack([torch.cos(phi), torch.sin(phi)])], dim=0)


def polyphase_stage2_plain(bd: torch.Tensor, r: int, ext: int, keep_bins: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same rounding points)."""
    b, ebp, kp2 = bd.shape
    kp = kp2 // 2
    rounded = bd.dtype == torch.bfloat16
    tab = tables.on(bd.device, stage2_tables, r)
    rows = ext + r - 1
    x = bd[:, :rows].to(torch.float32)
    dev = bd.device
    cls = ((torch.arange(rows, device=dev) % r)[:, None]
           * (torch.arange(kp, device=dev) % r)[None, :]) % r
    c, s = tab[0][cls], tab[1][cls]
    bre, bim = x[..., :kp], x[..., kp:]
    cre = bre * c - bim * s
    cim = bre * s + bim * c
    if rounded:
        cre = cre.to(torch.bfloat16).float()
        cim = cim.to(torch.bfloat16).float()
    # width-R box sum along frames, accumulated in ascending row order
    sre, sim = cre[:, :ext], cim[:, :ext]
    for i in range(1, r):
        sre = sre + cre[:, i:i + ext]
        sim = sim + cim[:, i:i + ext]
    ph = torch.arange(ext, device=dev) % r
    cphi, sphi = tab[2][ph][None, :, None], tab[3][ph][None, :, None]
    m1re = torch.cat([sre[..., 1:2], sre[..., :-1]], dim=-1)
    m1im = torch.cat([-sim[..., 1:2], sim[..., :-1]], dim=-1)
    p1re = torch.cat([sre[..., 1:], sre[..., -1:]], dim=-1)
    p1im = torch.cat([sim[..., 1:], sim[..., -1:]], dim=-1)
    wre = 0.5 * sre - 0.25 * ((m1re + p1re) * cphi + (m1im - p1im) * sphi)
    wim = 0.5 * sim - 0.25 * ((m1im + p1im) * cphi + (p1re - m1re) * sphi)
    mag = torch.sqrt(wre * wre + wim * wim)[..., :keep_bins]
    return mag.to(torch.bfloat16) if rounded else mag


def check_kernel_input(bd: torch.Tensor, r: int, ext: int, keep_bins: int) -> None:
    """Raise ``ValueError`` for input the CUDA kernel does not take."""
    if bd.dtype != torch.bfloat16 or bd.dim() != 3 or not bd.is_contiguous():
        raise ValueError("polyphase_stage2 kernel takes a contiguous bf16 [B, EBP, 2*KP] tensor,"
                         f" got {bd.dtype} {tuple(bd.shape)}")
    _, ebp, kp2 = bd.shape
    if r != KERNEL_RATIO:
        raise ValueError(f"polyphase_stage2 kernel is built for R={KERNEL_RATIO}, got R={r}")
    if kp2 % 4 or not 0 < keep_bins < kp2 // 2 or ext < 1 or ebp < ext + r - 1:
        raise ValueError(f"polyphase_stage2: bad shape {tuple(bd.shape)} for R={r}, "
                         f"ext={ext}, keep_bins={keep_bins}")
    if bd.data_ptr() % 4:
        raise ValueError("polyphase_stage2 kernel takes a 4-byte aligned tensor")


def bound_ms(b: int, ebp: int, kp: int, r: int, ext: int, keep_bins: int) -> dict:
    """The least time an H100 could take for one call, from its shapes alone.

    Bytes: the part of the bf16 block DFTs ``[B, EBP, 2 KP]`` that feeds an
    output, read once (``ext + R - 1`` rows, ``keep + 1`` columns of each of
    the re and im halves; the spare rows and the padded columns are never
    needed), and the bf16 magnitudes ``[B, ext, keep]`` written once, over
    3.35 TB/s. Operations: the twiddle of the same rows and columns (4
    products, 2 sums, 2 roundings), and per output the two fresh ``R``-term
    sums (``2 (R - 1)``), the mix (16) and the magnitude (5), over the
    67 TFLOP/s of the f32 SIMT units."""
    del ebp, kp  # the bound depends only on what feeds an output
    fed = (ext + r - 1) * (keep_bins + 1)
    n_bytes = 2 * b * (2 * fed + ext * keep_bins)
    n_ops = b * (8 * fed + ext * keep_bins * (2 * (r - 1) + 21))
    return cuda_build.roofline(n_bytes, n_ops)


def polyphase_stage2(bd: torch.Tensor, r: int, ext: int, keep_bins: int) -> torch.Tensor:
    """Stage 2 of the polyphase STFT: ``bd [B, EBP, 2*KP]`` -> magnitudes
    ``[B, ext, keep_bins]``. CPU tensors take the plain version; CUDA tensors
    launch the kernel (bf16 ``bd`` only) or raise."""
    if bd.device.type == "cpu":
        return polyphase_stage2_plain(bd, r, ext, keep_bins)
    if bd.device.type != "cuda":
        raise ValueError(f"polyphase_stage2: unsupported device {bd.device}")
    check_kernel_input(bd, r, ext, keep_bins)
    b, ebp, kp2 = bd.shape
    kp = kp2 // 2
    tab = tables.on(bd.device, stage2_tables, r)
    out = torch.empty((b, ext, keep_bins), dtype=torch.bfloat16, device=bd.device)
    lib = cuda_build.library()
    with torch.cuda.device(bd.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stratum_polyphase_stage2(bd.data_ptr(), tab.data_ptr(), out.data_ptr(),
                                          b, ebp, kp, r, ext, keep_bins, FRAME_TILE, stream)
    cuda_build.check(rc, "polyphase_stage2")
    tracing.count_launch(polyphase_stage2)
    return out


polyphase_stage2.launches = 0
