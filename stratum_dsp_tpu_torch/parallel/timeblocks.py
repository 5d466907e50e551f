"""Time-block ("sequence parallel") sharding of the sample-domain frontends
(port of ``stratum_dsp_tpu/parallel/timeblocks.py``).

The analogue of context parallelism for this workload (SURVEY §2.3): a long
track's sample axis is cut into contiguous blocks along a mesh's ``time``
axis. The STFT needs ``frame_size - hop`` samples of the right neighbour for
frames that straddle a block boundary (overlap-save), plus left context for
the flux reducers' previous-frame carries and the key path's +-margin
conditioning halo. Each block computes its frames with the same reducer as
the unsharded path (``ops.stft.stft_reduce``'s contract, the CUDA kernel of
the BPM reducer on a card); the per-frame features are tiny (~14 floats a
frame against 512 samples a hop), so they come back concatenated along
frames and everything downstream runs on the whole curves.

The layout is the JAX package's ``P("tracks", "time")``: a ``TimeBlocks``
holds a tracks shard's samples as one ``[rows, T / n_time]`` block a time
position, each on that position's device, and no device ever holds a whole
row. A block's context is the neighbours' edge samples alone, copied between
devices (``TimeBlocks.context``), which takes the place of the JAX package's
two ``ppermute``s, their wrap-around included: block 0's left context is the
last block's tail and the last block's right context is block 0's head, and
the frames they feed are masked by global frame index, as in JAX. The
outputs come back by ``torch.cat`` on the row's first device in place of
``all_gather``. Normalization and the trim shift run block by block too
(``preprocessing``).

Shapes follow the JAX package, not the unsharded path: the STFT outputs have
``n_time * fpb`` frames (``fpb = T / (n_time * hop)``), chunks are
``min(chunk_frames, fpb)`` frames, and the frame RMS has ``T // hop``
frames. One place differs from the JAX functions on purpose: where ``fpb``
is no multiple of the chunk, JAX's ``dynamic_slice`` clamps the last chunk's
start and so labels earlier frames as that chunk's; here the last chunk is
shorter and every frame is its own (``ROADMAP.md`` Queue 3).

Layout requirements: ``T % (n_time * hop) == 0`` and ``frame_size % hop == 0``
(true for every config the pipeline uses: 2048/{256,512,1024}, 8192/512).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import tracing
from ..config import AnalysisConfig
from ..features.period import novelty as nov
from ..ops import tables
from ..ops.masked import scan_sum, sqrt_f32
from ..ops.stft import hann_basis, stft_magnitude
from .mesh import Mesh, check_tracks_split, map_on_devices


def pad_to_time_multiple(samples: torch.Tensor, n_time: int, quantum: int):
    """Right-pad ``[B, T]`` so T is a multiple of ``n_time * quantum``."""
    t = samples.shape[1]
    m = n_time * quantum
    t_pad = -(-t // m) * m
    return F.pad(samples, (0, t_pad - t)) if t_pad != t else samples


@dataclasses.dataclass(frozen=True, eq=False)
class TimeBlocks:
    """A tracks shard's ``[rows, T]`` samples cut along time: ``blocks[j]``
    is the f32 ``[rows, t_blk]`` block of time position ``j``, on device
    ``mesh.grid()[0, j]`` of the shard's ``(1, n_time)`` mesh. ``shape``
    and ``device`` (the row's first device, where the features gather) stand
    in for a tensor's where a frontend reads them."""

    blocks: List[torch.Tensor]
    t: int
    t_blk: int
    mesh: Mesh

    @classmethod
    def from_samples(cls, samples, mesh: Mesh) -> "TimeBlocks":
        """Cut ``samples [rows, T]`` over the time axis of ``mesh`` (one row
        of a mesh). A host array (numpy or a CPU tensor) is cut there and
        each block copied straight to its device, through pinned memory to a
        card; a CUDA tensor is sliced and each block copied to its device
        (a view where it lies there already). No whole row is copied."""
        devices = list(mesh.grid()[0])
        if not torch.is_tensor(samples):
            samples = torch.as_tensor(np.asarray(samples))
        t = samples.shape[1]
        if t % len(devices):
            raise ValueError(f"T = {t} does not divide over a time axis of {len(devices)}")
        t_blk = t // len(devices)
        blocks = []
        for j, dev in enumerate(devices):
            part = samples[:, j * t_blk:(j + 1) * t_blk]
            if part.device.type == "cpu" and dev.type == "cuda":
                staged = torch.empty(part.shape, dtype=torch.float32, pin_memory=True)
                part = staged.copy_(part)
                tracing.count("h2d_bytes", staged.numel() * staged.element_size())
            blocks.append(part.to(device=dev, dtype=torch.float32, non_blocking=True))
        return cls(blocks, t, t_blk, mesh)

    @property
    def shape(self) -> tuple:
        return (self.blocks[0].shape[0], self.t)

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    @property
    def n_time(self) -> int:
        return len(self.blocks)

    def replace(self, blocks: List[torch.Tensor]) -> "TimeBlocks":
        return dataclasses.replace(self, blocks=blocks)

    def map(self, fn: Callable) -> list:
        """``[fn(blocks[j], j) for j]``, each call on block j's device (in
        one host thread each where those are distinct cards)."""
        return map_on_devices(lambda j: fn(self.blocks[j], j), list(range(self.n_time)),
                              [b.device for b in self.blocks])

    def context(self, j: int, left: int, right: int) -> torch.Tensor:
        """Block ``j`` with the last ``left`` samples of its left neighbour
        before it and the first ``right`` of its right neighbour after it,
        on block j's device; the neighbours wrap around, as the JAX
        package's ``ppermute`` ring does. Only those edge samples are
        copied between devices."""
        if left > self.t_blk or right > self.t_blk:
            raise ValueError(f"a block of {self.t_blk} samples cannot hold its neighbours' "
                             f"context ({left} left, {right} right): use fewer time blocks")
        blk = self.blocks[j]
        parts = [blk]
        if left:
            edge = self.blocks[(j - 1) % self.n_time][:, self.t_blk - left:]
            parts.insert(0, edge.to(blk.device, non_blocking=True))
        if right:
            edge = self.blocks[(j + 1) % self.n_time][:, :right]
            parts.append(edge.to(blk.device, non_blocking=True))
        return torch.cat(parts, dim=1) if len(parts) > 1 else blk

    def index_select(self, dim: int, index: torch.Tensor) -> "TimeBlocks":
        """The rows ``index`` of every block, block by block (``dim`` 0, as
        ``Tensor.index_select`` takes it)."""
        if dim != 0:
            raise ValueError("TimeBlocks select rows only (dim 0)")
        return self.replace([b.index_select(0, index.to(b.device)) for b in self.blocks])

    def masked(self, lengths: torch.Tensor) -> "TimeBlocks":
        """Every row zeroed from its ``lengths`` on, block by block."""
        def run(blk, j):
            gidx = j * self.t_blk + torch.arange(self.t_blk, device=blk.device)
            return torch.where(gidx[None, :] < lengths.to(blk.device)[:, None], blk, 0.0)

        return self.replace(self.map(run))

    def shifted(self, starts: List[int], lengths: List[int]) -> "TimeBlocks":
        """Row ``r`` moved left by ``starts[r]`` samples and zeroed from
        ``lengths[r]`` on (host ints, ``starts[r] + lengths[r] <= T``). Row
        r of block j reads samples ``[j t_blk + s, (j + 1) t_blk + s)``,
        which lie in at most two blocks: only those pieces are copied, and
        only up to the row's length. Rows that do not move are masked in
        place of their copy."""
        n = torch.as_tensor(lengths, dtype=torch.int64)
        out = self.masked(n).blocks
        for r, (s, ln) in enumerate(zip(starts, lengths)):
            if s == 0:
                continue
            for j, dst in enumerate(out):
                dst[r].zero_()
                lo = j * self.t_blk
                m = min(max(ln - lo, 0), self.t_blk)  # samples this block keeps
                pos = 0
                while pos < m:
                    k, off = divmod(lo + pos + s, self.t_blk)
                    take = min(m - pos, self.t_blk - off)
                    dst[r, pos:pos + take].copy_(self.blocks[k][r, off:off + take],
                                                 non_blocking=True)
                    pos += take
        return self.replace(out)


def time_blocks(samples, mesh: Mesh) -> List[TimeBlocks]:
    """``samples [B, T]`` (numpy, or a tensor on the host or a card) as one
    ``TimeBlocks`` a tracks shard of ``mesh``, cut as ``from_samples`` cuts."""
    bl = check_tracks_split(samples.shape[0], mesh)
    return [TimeBlocks.from_samples(samples[i * bl:(i + 1) * bl], mesh.row(i))
            for i in range(mesh.grid().shape[0])]


def _n_time(samples, mesh: Mesh) -> int:
    return samples.n_time if isinstance(samples, TimeBlocks) else mesh.shape["time"]


def _map_blocks(samples, counts: torch.Tensor, mesh: Mesh, left_ctx: int, right_ctx: int,
                block_fn: Callable) -> Dict[str, torch.Tensor]:
    """Run ``block_fn(ext, counts, j)`` for every (tracks shard, time block
    j) on the block's device, with ``ext`` the block plus ``left_ctx`` /
    ``right_ctx`` samples of its neighbours (``TimeBlocks.context``) and
    ``counts`` the rows' per-track counts [rows] (samples or frames);
    concatenate each output ``[rows, frames, ...]`` along frames within a
    shard and along rows across shards, on the first block's device.
    ``samples`` is one shard's ``TimeBlocks`` or a ``[B, T]`` tensor, which
    is first cut into blocks over ``mesh``."""
    if isinstance(samples, TimeBlocks):
        shards, home = [samples], samples.device
    else:
        shards, home = time_blocks(samples, mesh), samples.device
    outs, r0 = [], 0
    for shard in shards:
        rows = slice(r0, r0 + shard.shape[0])
        r0 = rows.stop
        res = shard.map(lambda blk, j: block_fn(shard.context(j, left_ctx, right_ctx),
                                                counts[rows].to(blk.device), j))
        outs.append({k: torch.cat([o[k].to(home) for o in res], dim=1) for k in res[0]})
    return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}


def stft_reduce_sharded(samples: torch.Tensor, lengths: torch.Tensor, frame_size: int, hop: int,
                        reducer: Callable, carry_init: Callable, mesh: Mesh, *,
                        prev_frames: int = 2, halo_frames: int = 0, keep_bins=None,
                        chunk_frames: int = 512, out_template: Optional[Dict] = None,
                        bf16: bool = False):
    """Time-sharded equivalent of ``ops.stft.stft_reduce``.

    ``samples``: a ``[B, T]`` tensor, cut into blocks over ``mesh``, or one
    tracks shard's ``TimeBlocks``, T divisible by ``n_time * hop``; the reducer
    contract of ``stft_reduce``: the reducer sees GLOBAL frame indices, a
    chunk's spectra with ``halo_frames`` of context on each side, and a carry
    threaded across its block's chunks.

    ``prev_frames``: how many previous spectral frames the carry stands
    for; a block's first carry is built from the real frames before the
    block (``_carry_from_prev``), so the results equal the unsharded scan's.

    ``out_template`` is the JAX signature's (shard_map needs its outputs'
    keys up front); the outputs here are whatever the reducer returns.

    Returns ``(outs [B, n_time * fpb, ...], n_time * fpb, frame_counts [B])``.
    """
    del out_template
    b, t = samples.shape
    n_time = _n_time(samples, mesh)
    if frame_size % hop:
        raise ValueError(f"frame_size {frame_size} must be a multiple of hop {hop}")
    if t % (n_time * hop):
        raise ValueError(f"padded length {t} must be divisible by n_time*hop = {n_time * hop}")
    fpb = t // n_time // hop  # frames starting in each block
    lead = prev_frames + halo_frames
    nf_total = max((t - frame_size) // hop + 1, 0)
    frame_counts = torch.where(lengths >= frame_size, (lengths - frame_size) // hop + 1, 0)
    chunk = int(min(chunk_frames, fpb))

    def block_fn(ext, fc, j):
        # ext frame k starts at ext sample k*hop; central frames are
        # k in [lead, lead + fpb), global frame index j*fpb + k - lead
        dev, bl = ext.device, ext.shape[0]
        basis = tables.on(dev, hann_basis, frame_size, keep_bins, bf16)
        fc = fc.clamp_max(nf_total)

        def spectra(k0: int, n: int):
            """Masked spectra of ext frames [k0, k0 + n) and their global
            indices and validity."""
            region = ext[:, k0 * hop:k0 * hop + (n - 1) * hop + frame_size]
            f0 = j * fpb + k0 - lead
            fidx = f0 + torch.arange(n, device=dev)
            fvalid = (fidx[None, :] >= 0) & (fidx[None, :] < fc[:, None])
            return stft_magnitude(region, n, hop, basis, f0, fc), fidx, fvalid

        if prev_frames > 0:
            # the block's carry: the real previous frames' spectra (zero at
            # track start, where the wrapped-around frames are invalid)
            carry = _carry_from_prev(carry_init, bl, spectra(halo_frames, prev_frames)[0])
        else:
            carry = carry_init(bl)
        if torch.is_tensor(carry):
            carry = carry.to(dev)
        outs = []
        for c0 in range(0, fpb, chunk):
            c = min(chunk, fpb - c0)
            spec, fidx, fvalid = spectra(lead + c0 - halo_frames, c + 2 * halo_frames)
            o, carry = reducer(spec, fidx, fvalid, carry)
            outs.append(o)
        return {k: torch.cat([o[k] for o in outs], dim=1) for k in outs[0]}

    left_ctx = lead * hop
    right_ctx = halo_frames * hop + (frame_size - hop)
    outs = _map_blocks(samples, frame_counts, mesh, left_ctx, right_ctx, block_fn)
    return outs, n_time * fpb, frame_counts


def _carry_from_prev(carry_init: Callable, b: int, prev_spec: torch.Tensor):
    """The reducer carry from the real previous frames' spectra.

    The pipeline's flux reducers carry the last ``prev_frames`` raw
    magnitude frames as ``[B, prev, K]``; a reducer with another carry keeps
    ``carry_init``'s."""
    c0 = carry_init(b)
    if torch.is_tensor(c0) and c0.shape == prev_spec.shape:
        return prev_spec
    return c0


def frame_rms_sharded(samples: torch.Tensor, lengths: torch.Tensor, frame_size: int, hop: int,
                      mesh: Mesh):
    """Time-sharded per-frame RMS on the reference frame grid
    (energy_flux.rs:105-131 / silence.rs:144-169: frames at i*hop, clamped to
    each track's end).

    ``samples`` as for ``stft_reduce_sharded``; requires
    ``T % (n_time * hop) == 0``. Returns ``(rms [B, NF], n_frames
    [B])`` with NF = T // hop (the padded grid: frames that would start past
    T - frame_size are still emitted; callers mask by n_frames). Each block's
    sums of squares are one prefix sum over the block and its right context,
    added in XLA:CPU's order for ``jnp.cumsum`` (``ops.masked.scan_sum``), as
    the JAX function adds them, and the root is IEEE-rounded
    (``ops.masked.sqrt_f32``): the result is the JAX function's bit for bit."""
    b, t = samples.shape
    n_time = _n_time(samples, mesh)
    if t % (n_time * hop):
        raise ValueError(f"padded length {t} must be divisible by n_time*hop = {n_time * hop}")
    t_blk = t // n_time
    fpb = t_blk // hop

    def block_fn(ext, ln, j):
        dev = ext.device
        base = j * t_blk
        # clamp-to-end semantics: zero samples at/after the track length
        gidx = base + torch.arange(ext.shape[1], device=dev)
        ext = torch.where(gidx[None, :] < ln[:, None], ext, 0.0)
        c = F.pad(scan_sum(ext * ext), (1, 0))
        starts = torch.arange(fpb, device=dev) * hop
        g_starts = base + starts
        ends = torch.minimum(g_starts[None, :] + frame_size, ln.clamp_min(1)[:, None])
        ends = torch.maximum(ends, g_starts[None, :] + 1)
        l_ends = (ends - base).clamp(0, ext.shape[1])
        sums = torch.gather(c, 1, l_ends) - c[:, starts]
        cnt = (ends - g_starts[None, :]).to(sums.dtype)
        return {"rms": sqrt_f32(sums.clamp_min(0.0) / cnt.clamp_min(1.0))}

    rms = _map_blocks(samples, lengths, mesh, 0, frame_size - hop, block_fn)["rms"]
    n_frames = torch.where(lengths >= frame_size, (lengths - frame_size) // hop + 1, 0)
    return rms, n_frames


def compute_bpm_spectral_features_sharded(samples: torch.Tensor, lengths: torch.Tensor,
                                          cfg: AnalysisConfig, sample_rate: int, frame_size: int,
                                          hop: int, mesh: Mesh, chunk_frames: int = 512,
                                          emit_stride2=None, emit_onset_flux: bool = True):
    """Time-sharded ``novelty.compute_bpm_spectral_features`` (same returns).
    On a card every chunk of every block launches the fused novelty kernel."""
    reducer, carry_init, band_names = nov.make_bpm_reducer(
        cfg, sample_rate, frame_size, samples.device, emit_stride2=emit_stride2,
        emit_onset_flux=emit_onset_flux)
    outs, nf_padded, frame_counts = stft_reduce_sharded(
        samples, lengths, frame_size, hop, reducer, carry_init, mesh,
        prev_frames=2, chunk_frames=chunk_frames, bf16=cfg.stft_bf16)
    outs["band_names"] = band_names
    return outs, frame_counts, nf_padded
