"""Blocked frame sums of squares (port of ``stratum_dsp_tpu/ops/framesum.py``).

Frame grids here always have ``frame_size % hop == 0``, so every frame
boundary is a multiple of ``gcd(hop, frame_size)``: one block-sum pass plus a
prefix over the block axis gives every frame sum. Exact given the batch
contract (zeros beyond each track's length).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .masked import scan_sum, sqrt_f32, tree_sum


def block_prefix_sumsq(samples: torch.Tensor, blk: int) -> torch.Tensor:
    """``c [B, nb+1]`` with ``c[i] = sum(x[: i*blk] ** 2)``."""
    b, t = samples.shape
    nb = -(-t // blk)
    x = F.pad(samples, (0, nb * blk - t))
    # summed in the reference's compiled order: the frames' RMS sits beside
    # the energy-flux onset threshold and the silence gate
    bs = tree_sum((x * x).reshape(b, nb, blk))
    return F.pad(scan_sum(bs), (1, 0))


def frame_sumsq(samples: torch.Tensor, frame_size: int, hop: int, nf: int) -> torch.Tensor:
    """Sum of squares over frames ``[i*hop, i*hop + frame_size)``, i < nf."""
    blk = math.gcd(hop, frame_size)
    c = block_prefix_sumsq(samples, blk)
    nb = c.shape[1] - 1
    si = torch.clamp(torch.arange(nf, device=samples.device) * (hop // blk), max=nb)
    ei = torch.clamp(si + frame_size // blk, max=nb)
    return c[:, ei] - c[:, si]


def frame_rms(samples: torch.Tensor, lengths: torch.Tensor, frame_size: int, hop: int):
    """Per-frame RMS over frames at ``i*hop`` clamped to each track's end
    (silence.rs:144-169, energy_flux.rs:105-131): ``[B, NF]`` on the padded
    grid, NF = max((T - frame_size) // hop + 1, 1)."""
    nf = max((samples.shape[1] - frame_size) // hop + 1, 1)
    sums = frame_sumsq(samples, frame_size, hop, nf)
    starts = torch.arange(nf, device=samples.device) * hop
    ends = torch.minimum(starts[None, :] + frame_size, lengths.clamp_min(1)[:, None])
    ends = torch.maximum(ends, starts[None, :] + 1)
    return sqrt_f32(sums.clamp_min(0.0) / (ends - starts[None, :]).to(sums.dtype))
