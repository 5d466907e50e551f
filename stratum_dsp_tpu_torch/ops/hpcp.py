"""The HPCP of the bisection peak pick: the CUDA kernel's wrapper and its plain
PyTorch version.

A kernel with no TPU counterpart (``csrc/hpcp_bisect.cu``): the JAX package
leaves the approximate top-K HPCP of ``features/chroma/extractor.py
frames_to_hpcp`` to XLA. For each frame of ``n`` bins (``sel``, the rows the
peaks are picked from, whitened or not; ``raw``, the magnitudes they are
weighted by) it

1. marks the peaks: bins in the band ``[k_lo, k_hi)`` with ``sel > prev`` and
   ``sel >= next``, the row's edge bins repeated as neighbours;
2. bisects 20 times for the ``k_top``-th largest peak value, in ``sel``'s
   dtype, and keeps the peaks at or above the threshold it finds;
3. weights each kept bin by ``max(raw, 0) ** p`` in ``raw``'s dtype, and sums
   the weights times their rows of the harmonic matrix ``[n, 12]`` (one, or
   one a leading index of the rows: ``[B, n, 12]`` for rows ``[B, F, n]``);
4. L2-normalises the 12 sums, zero where the norm is at most 1e-10
   (``features/chroma/postprocess.py:l2_normalize_zero``).

Dispatch goes by the input's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from .. import tracing
from . import cuda_build

BISECTION_STEPS = 20
NORM_FLOOR = 1e-10  # l2_normalize_zero's
_DTYPES = (torch.float32, torch.bfloat16)


def peak_band(n_bins: int, hi_bin: int, sample_rate: int, fft_size: int, fmin: float,
              fmax: float) -> tuple:
    """``(k_lo, k_hi)``: the bins ``k < hi_bin`` a peak may lie on, those of
    the spectrum's interior (``1 <= k < n_bins - 1``) whose frequency
    ``k * (sample_rate / fft_size)`` lies in ``[fmin, fmax]``. Empty where
    ``k_lo == k_hi``."""
    df = sample_rate / fft_size
    top = min(hi_bin, n_bins - 1)
    k_lo = max(1, math.ceil(fmin / df))
    while k_lo * df < fmin:  # the quotient's rounding, either way
        k_lo += 1
    while k_lo > 1 and (k_lo - 1) * df >= fmin:
        k_lo -= 1
    k_hi = min(top, math.floor(fmax / df) + 1)
    while k_hi > k_lo and (k_hi - 1) * df > fmax:
        k_hi -= 1
    while k_hi < top and k_hi * df <= fmax:
        k_hi += 1
    k_lo = min(k_lo, top)
    return k_lo, max(k_hi, k_lo)


def hpcp_bisect_plain(raw: torch.Tensor, sel: torch.Tensor, band: tuple, k_top: int, p: float,
                      matrix: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``hpcp_bisect``: ``raw`` and ``sel``
    ``[..., n]``, ``matrix [n, 12]`` or ``[..., n, 12]`` f32 -> ``[..., 12]``
    f32."""
    k = torch.arange(sel.shape[-1], device=sel.device)
    static_ok = (k >= band[0]) & (k < band[1])
    prev = torch.cat([sel[..., :1], sel[..., :-1]], dim=-1)
    nxt = torch.cat([sel[..., 1:], sel[..., -1:]], dim=-1)
    peak_ok = static_ok & (sel > prev) & (sel >= nxt)
    peak_vals = torch.where(peak_ok, sel, float("-inf"))
    raw = raw.clamp_min(0.0)
    # bisect tau ~ the k-th largest peak value: count(>= lo) >= k_top >=
    # count(>= hi); with fewer than k_top peaks lo stays 0 and all are kept
    hi = torch.where(peak_ok, sel, 0.0).amax(dim=-1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(BISECTION_STEPS):
        mid = 0.5 * (lo + hi)
        take_lower = ((peak_vals >= mid) & peak_ok).sum(dim=-1, keepdim=True) < k_top
        hi = torch.where(take_lower, mid, hi)
        lo = torch.where(take_lower, lo, mid)
    mask = peak_ok & (peak_vals >= lo)
    w_bins = torch.where(mask, torch.sqrt(raw) if p == 0.5 else torch.pow(raw, p), 0.0)
    sums = torch.matmul(w_bins.to(torch.float32), matrix)
    norm = torch.sqrt((sums * sums).sum(dim=-1, keepdim=True))
    return torch.where(norm > NORM_FLOOR, sums / norm.clamp_min(NORM_FLOOR), 0.0)


def _rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x [..., n]`` as ``[rows, n]`` with unit stride along a row (a view
    where one exists)."""
    x2 = x.reshape(-1, n)
    return x2 if x2.stride(-1) == 1 else x2.contiguous()


def _matrices(matrix: torch.Tensor, lead: tuple, n: int) -> tuple:
    """``(matrices [m, n, 12], rows a matrix, floats between matrices)``: one
    shared matrix, or one for each index of the rows' leading axes but the
    last (``[B, n, 12]`` for rows ``[B, F, n]``)."""
    if matrix.dtype != torch.float32 or matrix.shape[-2:] != (n, 12):
        raise ValueError(f"hpcp_bisect kernel takes an f32 [..., {n}, 12] matrix, got "
                         f"{matrix.dtype} {tuple(matrix.shape)}")
    if matrix.dim() == 2:
        mats, per = matrix[None], max(math.prod(lead), 1)
    else:
        try:
            mats = matrix.expand(lead[:-1] + (n, 12)).reshape(-1, n, 12)
        except RuntimeError as exc:
            raise ValueError(f"hpcp_bisect kernel: matrices {tuple(matrix.shape)} do not match "
                             f"rows {lead}") from exc
        per = lead[-1]
    if mats.stride()[1:] != (12, 1):
        mats = mats.contiguous()
    return mats, per, mats.stride(0) if mats.shape[0] > 1 else 0


def hpcp_bisect_bound_ms(rows: int, n: int, k_top: int) -> dict:
    """The least time an H100 could take for one call on ``rows`` f32 frames
    of ``n`` bins.

    Bytes: every bin read once, the harmonic matrix ``[n, 12]`` f32 read
    once, and the ``[rows, 12]`` f32 output written once, over 3.35 TB/s.
    Operations: the peak test's two compares a bin, one compare a bin for
    each bisection step, and a kept bin's 12 products and sums, over
    67 TFLOP/s."""
    n_bytes = rows * (4 * n + 48) + 48 * n
    n_ops = rows * (n * (2 + BISECTION_STEPS) + 24 * k_top)
    return cuda_build.roofline(n_bytes, n_ops)


def hpcp_bisect(raw: torch.Tensor, sel: torch.Tensor, band: tuple, k_top: int, p: float,
                matrix: torch.Tensor) -> torch.Tensor:
    """HPCP ``[..., 12]`` f32 of the frames ``[..., n]``: peaks of ``sel`` in
    the bins ``band = (k_lo, k_hi)``, the top ``k_top`` of them by a 20-step
    bisection, weighted by ``max(raw, 0) ** p``, summed through ``matrix``
    (``[n, 12]``, or ``[..., n, 12]`` for the rows' leading axes but the
    last) and L2-normalised. ``raw`` and ``sel`` are f32 or bf16 each, with
    the same shape (``sel`` may be ``raw`` itself). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if sel.device.type == "cpu":
        return hpcp_bisect_plain(raw, sel, band, k_top, p, matrix)
    if sel.device.type != "cuda":
        raise ValueError(f"hpcp_bisect: unsupported device {sel.device}")
    if raw.shape != sel.shape or raw.dtype not in _DTYPES or sel.dtype not in _DTYPES:
        raise ValueError(f"hpcp_bisect kernel takes f32 or bf16 raw and sel of one shape, got "
                         f"{raw.dtype} {tuple(raw.shape)} and {sel.dtype} {tuple(sel.shape)}")
    if raw.device != sel.device or matrix.device != sel.device:
        raise ValueError("hpcp_bisect: raw, sel and matrix on different devices")
    n, lead = sel.shape[-1], tuple(sel.shape[:-1])
    if n < 1 or k_top < 1 or max(math.prod(lead), n) >= 1 << 31:
        raise ValueError(f"hpcp_bisect kernel: bad shape {tuple(sel.shape)}, k_top {k_top}")
    out = torch.empty(lead + (12,), dtype=torch.float32, device=sel.device)
    if not out.numel():
        return out
    raw2, sel2 = _rows(raw, n), _rows(sel, n)
    mats, per, mat_stride = _matrices(matrix, lead, n)
    lib = cuda_build.library()
    with torch.cuda.device(sel.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stratum_hpcp_bisect(
            sel2.data_ptr(), sel2.stride(0), int(sel2.dtype == torch.bfloat16),
            raw2.data_ptr(), raw2.stride(0), int(raw2.dtype == torch.bfloat16),
            mats.data_ptr(), mat_stride, per, out.data_ptr(), sel2.shape[0], n,
            int(band[0]), int(band[1]), int(k_top), float(p), int(p == 0.5), stream)
    cuda_build.check(rc, "hpcp_bisect")
    tracing.count_launch(hpcp_bisect)
    tracing.count("hpcp_kernel")
    return out


hpcp_bisect.launches = 0
