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

import functools

import numpy as np
import torch

from . import cuda_build

NUM_STATES = 5


def transition_matrix() -> np.ndarray:
    """Row-normalized 0.7/0.15 band matrix ``[5, 5]`` f32, built as the TPU
    kernel builds it (hmm.rs:184-219)."""
    i = np.arange(NUM_STATES)[:, None]
    j = np.arange(NUM_STATES)[None, :]
    d = np.abs(i - j)
    m = np.where(d == 0, 0.7, np.where(d == 1, 0.15, 0.0)).astype(np.float32)
    return m / m.sum(axis=1, keepdims=True)


@functools.lru_cache(maxsize=16)
def _transitions_on(device: str) -> torch.Tensor:
    """The table on ``device``, copied there once: a host-to-device copy per
    call would stall the stream."""
    return torch.as_tensor(transition_matrix(), device=device)


def viterbi_decode_plain(emissions: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a loop over frames on ``[B, 5]``."""
    b, t = emissions.shape
    trans = _transitions_on(str(emissions.device))
    v = torch.full((b, NUM_STATES), 1.0 / NUM_STATES, device=emissions.device) \
        * emissions[:, :1]
    backptrs = torch.zeros((b, t, NUM_STATES), dtype=torch.int64, device=emissions.device)
    for i in range(1, t):
        scores = v[:, :, None] * trans  # [B, prev, state]
        # argmax keeps the first maximum, like the kernel's strict `>`
        backptrs[:, i] = scores.argmax(dim=1)
        v = scores.amax(dim=1) * emissions[:, i:i + 1]
    states = torch.empty((b, t), dtype=torch.int64, device=emissions.device)
    states[:, -1] = v.argmax(dim=-1)
    for i in range(t - 1, 0, -1):
        states[:, i - 1] = torch.gather(backptrs[:, i], 1, states[:, i:i + 1])[:, 0]
    return states.to(torch.int32)


def bound_ms(b: int, t: int) -> dict:
    """The least time an H100 could take for one call, from its shapes alone.

    Bytes: the f32 emissions and the transition table read once, the int32
    states written once, over 3.35 TB/s; operations: per frame and state 3
    products, 2 compares and the emission product. Neither says much: the
    forward pass is a chain of ``T - 1`` dependent steps (product, two
    compare-selects, product, and a shuffle to the neighbouring states) and
    the backtrack a chain of ``T - 1`` dependent shared-memory loads;
    ``chain_floor_ms`` is the time of the two."""
    bound = cuda_build.roofline(b * t * 4 + NUM_STATES * NUM_STATES * 4 + b * t * 4,
                                b * t * NUM_STATES * 6)
    bound["chain_floor_ms"] = (cuda_build.chain_floor_ms(t - 1, f32_ops=4, smem_ops=1)
                               + cuda_build.chain_floor_ms(t - 1, f32_ops=0, smem_ops=1))
    return bound


def viterbi_decode(emissions: torch.Tensor) -> torch.Tensor:
    """Decode the states ``[B, T]`` int32 from emissions ``[B, T]`` f32. CPU
    tensors take the plain version; CUDA tensors launch the kernel or raise."""
    if emissions.device.type == "cpu":
        return viterbi_decode_plain(emissions)
    if emissions.device.type != "cuda":
        raise ValueError(f"viterbi_decode: unsupported device {emissions.device}")
    if emissions.dim() != 2 or emissions.dtype != torch.float32 or emissions.shape[1] < 1:
        raise ValueError(f"viterbi_decode kernel takes f32 [B, T] emissions, got "
                         f"{emissions.dtype} {tuple(emissions.shape)}")
    b, t = emissions.shape
    lib = cuda_build.library()
    if t > lib.stratum_viterbi_max_frames():
        raise ValueError(f"viterbi_decode kernel takes at most "
                         f"{lib.stratum_viterbi_max_frames()} frames, got {t}")
    emissions = emissions.contiguous()
    trans = _transitions_on(str(emissions.device))
    states = torch.empty((b, t), dtype=torch.int32, device=emissions.device)
    with torch.cuda.device(emissions.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stratum_viterbi_decode(emissions.data_ptr(), trans.data_ptr(),
                                        states.data_ptr(), b, t, stream)
    cuda_build.check(rc, "viterbi_decode")
    viterbi_decode.launches += 1
    return states


viterbi_decode.launches = 0
