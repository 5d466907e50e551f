"""Greedy downbeat marking: the CUDA kernel's wrapper and its plain PyTorch
version.

Port of the Pallas TPU kernel ``stratum_dsp_tpu/ops/downbeats_pallas.py``
(``downbeat_mask``) and the scan it replaces in
``features/beat/grid.py:detect_downbeats`` (mod.rs:363-404): over compacted
ascending beat times, the first valid beat is a downbeat and a later beat is
one iff ``|t - (last_downbeat + bar)| <= 0.1 * bar``.

Dispatch goes by the input's device: a CPU tensor takes the plain version, a
CUDA tensor launches ``csrc/downbeat_mask.cu`` or raises.
"""

from __future__ import annotations

import torch

from .. import tracing
from . import cuda_build


# the kernel's block and its shared memory per beat slot (kThreads and
# kBytesPerSlot in csrc/downbeat_mask.cu), for timing an empty launch of its grid
BLOCK_THREADS = 512
SMEM_BYTES_PER_SLOT = 12
# the long path's fixed shared memory (downbeat_long_kernel: kLongSlots = 4096
# slots of 12 bytes), for the same
LONG_SMEM_BYTES = 4096 * 12


def downbeat_mask_plain(times: torch.Tensor, n_beats: torch.Tensor, bar: torch.Tensor):
    """Plain PyTorch version: the reference's walk as a loop over slots."""
    n = times.shape[-1]
    tol = bar * 0.1
    last = torch.zeros_like(bar)
    any_db = torch.zeros_like(bar, dtype=torch.bool)
    out = []
    for i in range(n):
        t = times[:, i]
        ok = i < n_beats
        first = ok & ~any_db
        hit = ok & any_db & ((t - (last + bar)).abs() <= tol)
        is_db = first | hit
        last = torch.where(is_db, t, last)
        any_db = any_db | is_db
        out.append(is_db)
    return torch.stack(out, dim=-1)


def bound_ms(b: int, n: int, n_beats=None) -> dict:
    """The least time an H100 could take for one call.

    Bytes: the f32 times, the int32 counts and f32 bar lengths read once, the
    one-byte mask written once, over 3.35 TB/s; operations: 6 per slot
    (validity, add, subtract, absolute value, compare, select). With
    ``n_beats`` (a sequence of the batch's counts) only the slots below each
    count are read and tested, which is what that data needs; without it all
    ``n`` of every row. Neither time says much: the kernel is a dependent
    chain of one vote per downbeat and per 32 slots, and under it the launch
    itself, which ``measure.empty_launch_ms`` times."""
    walked = b * n if n_beats is None else int(sum(min(max(int(k), 0), n) for k in n_beats))
    return cuda_build.roofline(walked * 4 + b * 8 + b * n, 6 * walked)


def downbeat_mask(times: torch.Tensor, n_beats: torch.Tensor, bar: torch.Tensor):
    """Downbeat mask ``[B, N]`` bool for ``times [B, N]`` f32, ``n_beats [B]``
    int, ``bar [B]`` f32 seconds. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise. Rows of up to
    ``stratum_downbeat_max_slots()`` slots (19,370) take the kernel's
    shared-memory path, longer ones its long path, which walks them in tiles
    of 4,096 slots."""
    if times.device.type == "cpu":
        return downbeat_mask_plain(times, n_beats, bar)
    if times.device.type != "cuda":
        raise ValueError(f"downbeat_mask: unsupported device {times.device}")
    if times.dim() != 2 or times.dtype != torch.float32:
        raise ValueError(f"downbeat_mask kernel takes f32 [B, N] times, got "
                         f"{times.dtype} {tuple(times.shape)}")
    b, n = times.shape
    for name, x in (("n_beats", n_beats), ("bar", bar)):
        if x.shape != (b,) or x.device != times.device:
            raise ValueError(f"downbeat_mask: {name} must be [{b}] on {times.device}")
    if n >= 2**31:
        raise ValueError(f"downbeat_mask kernel takes fewer than 2**31 slots, got {n}")
    lib = cuda_build.library()
    times = times.contiguous()
    nb = n_beats.to(torch.int32).contiguous()
    bar = bar.to(torch.float32).contiguous()
    # the kernel writes one byte of 0 or 1 a slot, which is a bool tensor's
    # storage: no conversion pass after it
    out = torch.empty((b, n), dtype=torch.bool, device=times.device)
    with torch.cuda.device(times.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stratum_downbeat_mask(times.data_ptr(), nb.data_ptr(), bar.data_ptr(),
                                       out.data_ptr(), b, n, stream)
    cuda_build.check(rc, "downbeat_mask")
    tracing.count_launch(downbeat_mask)
    return out


downbeat_mask.launches = 0
