"""The 5-state HMM Viterbi decode: the plain PyTorch version of
the CUDA kernel.

Port of the Pallas TPU kernel ``stratum_dsp_tpu/ops/viterbi_pallas.py``
(``viterbi_decode``) and the ``lax.scan`` decode of
``features/beat/hmm.py:track_beats`` (hmm.rs:308-375): tempo states
+-10% in 5% steps, transitions 0.7 self / 0.15 adjacent with rows
normalized, multiplicative f32 probabilities from a uniform prior, the first
maximum on ties, and a backtrack. Emissions are state-independent, so the
decode takes ``emissions [B, T]`` and returns the states ``[B, T]`` int32.

This frozen copy keeps only the plain version: the wrapper calls it on
every device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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
    call would stall the stream. The kernel's forward pass relies on the
    table's mirror symmetry (``trans[p][s] == trans[4-p][4-s]`` bit for bit),
    which is checked here."""
    table = transition_matrix()
    if table[::-1, ::-1].tobytes() != table.tobytes():
        raise AssertionError("the Viterbi transition table is not mirror-symmetric")
    return torch.as_tensor(table, device=device)


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
    trans = _transitions_on(str(emissions.device))
    v = torch.full((b, NUM_STATES), 1.0 / NUM_STATES, device=emissions.device) \
        * emissions[:, :1]
    backptrs = torch.zeros((b, t, NUM_STATES), dtype=torch.int64, device=emissions.device)
    for i in range(1, t):
        scores = v[:, :, None] * trans  # [B, prev, state]
        # argmax keeps the first maximum, like the kernel's strict `>`
        backptrs[:, i] = scores.argmax(dim=1)
        v = scores.amax(dim=1) * emissions[:, i:i + 1]
    return backtrack_plain(backptrs, v.argmax(dim=-1)).to(torch.int32)


def viterbi_decode(emissions: torch.Tensor) -> torch.Tensor:
    """Decode the states ``[B, T]`` int32 from emissions ``[B, T]`` f32: the
    plain version on every device."""
    return viterbi_decode_plain(emissions)


