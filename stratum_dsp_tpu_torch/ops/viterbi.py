"""The 5-state HMM Viterbi decode: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of the Pallas TPU kernel ``stratum_dsp_tpu/ops/viterbi_pallas.py``
(``viterbi_decode``) and the ``lax.scan`` decode of
``features/beat/hmm.py:track_beats`` (hmm.rs:308-375): tempo states
+-10% in 5% steps, transitions 0.7 self / 0.15 adjacent with rows
normalized, multiplicative f32 probabilities from a uniform prior, the first
maximum on ties, and a backtrack. Emissions are state-independent, so the
decode takes ``emissions [B, T]`` and returns the states ``[B, T]`` int32.

Dispatch goes by the input's device: a CPU tensor takes the plain version, a
CUDA tensor launches ``csrc/viterbi_decode.cu`` or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from . import cuda_build, tables

NUM_STATES = 5
# the kernel's block and its shared memory per frame (one warp, and
# kBytesPerFrame in csrc/viterbi_decode.cu), for timing an empty launch of its grid
BLOCK_THREADS = 32
SMEM_BYTES_PER_FRAME = 22
# the long path's fixed shared memory (viterbi_long_kernel: kLongTile = 2048
# frames of v and emissions), for the same
LONG_SMEM_BYTES = (2048 + 1) * 16 + 2048 * 4


def transition_matrix() -> np.ndarray:
    """Row-normalized 0.7/0.15 band matrix ``[5, 5]`` f32, built as the TPU
    kernel builds it (hmm.rs:184-219). The kernel's forward pass relies on
    its mirror symmetry (``trans[p][s] == trans[4-p][4-s]`` bit for bit),
    which is checked here."""
    i = np.arange(NUM_STATES)[:, None]
    j = np.arange(NUM_STATES)[None, :]
    d = np.abs(i - j)
    m = np.where(d == 0, 0.7, np.where(d == 1, 0.15, 0.0)).astype(np.float32)
    table = m / m.sum(axis=1, keepdims=True)
    if table[::-1, ::-1].tobytes() != table.tobytes():
        raise AssertionError("the Viterbi transition table is not mirror-symmetric")
    return table


def _transitions(device) -> torch.Tensor:
    return tables.on(device, transition_matrix, site="viterbi.transitions")


def backtrack_plain(backptrs: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """States ``[B, T]`` int64 from backpointers ``[B, T, 5]`` (frame t's map
    from the state at t to the state at t - 1; frame 0's is not read) and the
    state ``last [B]`` at frame T - 1: a loop over frames."""
    b, t = backptrs.shape[:2]
    states = torch.empty((b, t), dtype=torch.int64, device=backptrs.device)
    states[:, -1] = last
    for i in range(t - 1, 0, -1):
        states[:, i - 1] = torch.gather(backptrs[:, i], 1, states[:, i:i + 1])[:, 0]
    return states


def viterbi_decode_plain(emissions: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a loop over frames on ``[B, 5]``."""
    b, t = emissions.shape
    trans = _transitions(emissions.device)
    v = torch.full((b, NUM_STATES), 1.0 / NUM_STATES, device=emissions.device) \
        * emissions[:, :1]
    backptrs = torch.zeros((b, t, NUM_STATES), dtype=torch.int64, device=emissions.device)
    for i in range(1, t):
        scores = v[:, :, None] * trans  # [B, prev, state]
        # argmax keeps the first maximum, like the kernel's strict `>`
        backptrs[:, i] = scores.argmax(dim=1)
        v = scores.amax(dim=1) * emissions[:, i:i + 1]
    return backtrack_plain(backptrs, v.argmax(dim=-1)).to(torch.int32)


def live_frames(emissions: torch.Tensor) -> torch.Tensor:
    """Per row, the frames a decode of these emissions has to walk ``[B]``:
    up to and including the first frame at which all five probabilities are 0
    (from there on every backpointer and every state is 0 whatever the
    emissions say), and ``T`` where that never happens. A loop over frames,
    for ``bound_ms``."""
    b, t = emissions.shape
    trans = _transitions(emissions.device)
    v = torch.full((b, NUM_STATES), 1.0 / NUM_STATES, device=emissions.device) \
        * emissions[:, :1]
    frames = torch.full((b,), t, dtype=torch.int64, device=emissions.device)
    for i in range(t):
        if i:
            v = (v[:, :, None] * trans).amax(dim=1) * emissions[:, i:i + 1]
        frames = torch.where((v == 0).all(dim=1) & (frames == t), i + 1, frames)
    return frames


def bound_ms(b: int, t: int, frames=None) -> dict:
    """The least time an H100 could take for one call.

    Bytes: the f32 emissions and the transition table read once, the int32
    states written once, over 3.35 TB/s; operations: per frame and state 3
    products, 2 compares and the emission product. With ``frames`` (a
    sequence of ``live_frames``) only those frames of each row are read and
    walked, which is what that data needs; without it all ``t`` of every row.
    Neither time says much: the forward pass is a chain of dependent steps
    that no exact reassociation shortens, and under it stands the launch
    itself, which ``measure.empty_launch_ms`` times."""
    walked = b * t if frames is None else int(sum(min(max(int(k), 0), t) for k in frames))
    return cuda_build.roofline(walked * 4 + NUM_STATES * NUM_STATES * 4 + b * t * 4,
                               walked * NUM_STATES * 6)


def viterbi_decode(emissions: torch.Tensor) -> torch.Tensor:
    """Decode the states ``[B, T]`` int32 from emissions ``[B, T]`` f32. CPU
    tensors take the plain version; CUDA tensors launch the kernel or raise.
    Rows of up to ``stratum_viterbi_max_frames()`` frames (10,565) take the
    kernel's shared-memory path, longer ones its long path, which streams
    them and keeps a ``[B, T]`` int16 buffer of backpointers on the card."""
    if emissions.device.type == "cpu":
        return viterbi_decode_plain(emissions)
    if emissions.device.type != "cuda":
        raise ValueError(f"viterbi_decode: unsupported device {emissions.device}")
    if emissions.dim() != 2 or emissions.dtype != torch.float32 or emissions.shape[1] < 1:
        raise ValueError(f"viterbi_decode kernel takes f32 [B, T] emissions, got "
                         f"{emissions.dtype} {tuple(emissions.shape)}")
    b, t = emissions.shape
    if t >= 2**31:
        raise ValueError(f"viterbi_decode kernel takes fewer than 2**31 frames, got {t}")
    lib = cuda_build.library()
    emissions = emissions.contiguous()
    trans = _transitions(emissions.device)
    states = torch.empty((b, t), dtype=torch.int32, device=emissions.device)
    with torch.cuda.device(emissions.device):
        stream = torch.cuda.current_stream().cuda_stream
        if t > lib.stratum_viterbi_max_frames():
            # past shared memory the long path streams the row and keeps the
            # packed backpointers in device memory
            backptrs = torch.empty((b, t), dtype=torch.int16, device=emissions.device)
            rc = lib.stratum_viterbi_decode_long(emissions.data_ptr(), trans.data_ptr(),
                                                 backptrs.data_ptr(), states.data_ptr(), b, t,
                                                 stream)
        else:
            rc = lib.stratum_viterbi_decode(emissions.data_ptr(), trans.data_ptr(),
                                            states.data_ptr(), b, t, stream)
    cuda_build.check(rc, "viterbi_decode")
    tracing.count_launch(viterbi_decode)
    return states


viterbi_decode.launches = 0


def backtrack_on_card(backptrs: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """The kernel's backtrack alone (its warp scan over composed backpointer
    maps; past 8,192 frames the long path's tiles of it) on given backpointers ``[B, T, 5]`` and final states ``[B]`` on a
    CUDA device; states ``[B, T]`` int32. For the tests, which hold it to
    ``backtrack_plain`` on maps that real emissions cannot produce; nothing on
    the analysis path calls it, and it counts no launch."""
    if backptrs.device.type != "cuda" or backptrs.dim() != 3 \
            or backptrs.shape[2] != NUM_STATES:
        raise ValueError(f"backtrack_on_card takes [B, T, 5] backpointers on a CUDA device, got "
                         f"{tuple(backptrs.shape)} on {backptrs.device}")
    b, t = backptrs.shape[:2]
    if int(backptrs.min()) < 0 or int(backptrs.max()) >= NUM_STATES:
        raise ValueError("backtrack_on_card: backpointers must lie in 0..4")
    shifts = 3 * torch.arange(NUM_STATES, device=backptrs.device)
    packed = (backptrs.to(torch.int32) << shifts).sum(dim=-1).to(torch.int16).contiguous()
    last = last.to(device=backptrs.device, dtype=torch.int32).contiguous()
    states = torch.empty((b, t), dtype=torch.int32, device=backptrs.device)
    with torch.cuda.device(backptrs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = cuda_build.library().stratum_viterbi_backtrack(
            packed.data_ptr(), last.data_ptr(), states.data_ptr(), b, t, stream)
    cuda_build.check(rc, "viterbi_backtrack")
    return states
