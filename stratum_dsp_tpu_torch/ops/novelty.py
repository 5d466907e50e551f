"""The fused BPM novelty reducer: the CUDA kernel's wrapper, its plain
PyTorch version and the unpacking of their packed output.

Port of the Pallas TPU kernel ``stratum_dsp_tpu/ops/novelty_pallas.py``
(``fused_novelty_features``). For one STFT chunk ``spec [B, C, K]`` and the
two frames before it ``prev2 [B, 2, K]`` both versions return the TPU
kernel's packed ``[B, C, 128]`` f32 layout:

  cols [0, nb)          sqrt band SuperFlux sums, stride 1
  cols [nb, 2nb)        sqrt band SuperFlux sums, stride 2 (0 when off)
  cols [2nb, 4nb)       (energy, hfc) interleaved per band
  cols [4nb, 4nb+nm)    log-mel frames (0 when off)
  col  [4nb+nm]         onset spectral flux (0 when off)

and 0 in every other column. Band 0 is the full band; its max filter is
clamped at the array's edges, every sub-band's at the band's own edges.

Dispatch goes by the input's device: a CPU tensor takes the plain version, a
CUDA tensor launches ``csrc/fused_novelty.cu`` or raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import tracing
from . import cuda_build, masked

EPSILON = 1e-10
PCOLS = 128  # packed output columns
FRAME_TILE = 14  # frames per CUDA block: with its 2 halo rows, a row for each of 16 warps
BLOCK_THREADS = 512  # a warp per row, then a warp per frame
MEL_TASK_BINS = 24  # the widest piece of a mel filter one lane sums
# the kernel's limits (csrc/fused_novelty.cu: kMaxBins, kMaxBands, kMaxMels,
# kMaxMelPacked, kMaxEdges, kMaxMelTasks, kMaxMelRounds) and the shared memory
# one block of the card may take
KERNEL_MAX_BINS, KERNEL_MAX_BANDS, KERNEL_MAX_MELS, KERNEL_MAX_MEL_PACKED = 2048, 4, 128, 4096
KERNEL_MAX_EDGES, KERNEL_MAX_MEL_TASKS, KERNEL_MAX_MEL_ROUNDS = 256, 512, 8
KERNEL_MAX_SMEM = 232448


@dataclasses.dataclass(eq=False)
class NoveltyTables:
    """The reducer's constant tables, built once in numpy from the band edges
    (``bands``: (start, end) per band, band 0 the full band ``(0, K)``), the
    max-filter radius and the mel filterbank ``[K, nm]`` (or None)."""

    bands: Tuple[Tuple[int, int], ...]
    sf_k: int
    mel_w: Optional[np.ndarray]
    n_bins: int = dataclasses.field(init=False)
    sf_mask: np.ndarray = dataclasses.field(init=False)  # [K, nb] interior masks
    ew: np.ndarray = dataclasses.field(init=False)  # [K, 2nb] (1, k) per band
    # per sub-band i: [(lo, hi, t0, t1)] runs whose clamped filter differs
    # from the full-band one (the plain version's edge terms)
    edge_runs: tuple = dataclasses.field(init=False)
    _on: Dict[str, Dict[str, torch.Tensor]] = dataclasses.field(init=False, default_factory=dict)

    def __post_init__(self):
        self.bands = tuple((int(s), int(e)) for s, e in self.bands)
        self.n_bins = self.bands[0][1]
        if self.bands[0][0] != 0:
            raise ValueError(f"band 0 must be the full band, got {self.bands[0]}")
        k, nb = self.n_bins, len(self.bands)
        if PCOLS < 4 * nb + self.nm + 1:
            raise ValueError(f"packed feature columns exceed {PCOLS}: {nb} bands, "
                             f"{self.nm} mels")
        self.ew = np.zeros((k, 2 * nb), np.float32)
        self.sf_mask = np.zeros((k, nb), np.float32)
        self.sf_mask[:, 0] = 1.0
        runs = []
        for i, (s, e) in enumerate(self.bands):
            self.ew[s:e, 2 * i] = 1.0
            self.ew[s:e, 2 * i + 1] = np.arange(s, e, dtype=np.float32)
            if i == 0:
                continue
            if e - s <= 2 * self.sf_k:
                runs.append((i, ((s, e, 0, e - s),)))
            else:
                self.sf_mask[s + self.sf_k:e - self.sf_k, i] = 1.0
                runs.append((i, ((s, s + 2 * self.sf_k, 0, self.sf_k),
                                 (e - 2 * self.sf_k, e, self.sf_k, 2 * self.sf_k))))
        self.edge_runs = tuple(runs)

    @property
    def nb(self) -> int:
        return len(self.bands)

    @property
    def nm(self) -> int:
        return 0 if self.mel_w is None else self.mel_w.shape[1]

    @property
    def sub_bands(self) -> Tuple[Tuple[int, int, int], ...]:
        """(band column, start, end) of every band after the full one."""
        return tuple((i, s, e) for i, (s, e) in enumerate(self.bands) if i > 0)

    @functools.cached_property
    def bin_band(self) -> np.ndarray:
        """``[ceil(K / 4) * 4]`` uint8, a byte a bin: the column of the
        sub-band that holds the bin, 0 where none does (and past K). The
        kernel reads four bins' bytes as one word. Needs disjoint sub-bands
        (``check_kernel_input``)."""
        bands = np.zeros(-(-self.n_bins // 4) * 4, np.uint8)
        for i, s, e in self.sub_bands:
            bands[s:e] = i
        return bands

    @functools.cached_property
    def edge_windows(self) -> np.ndarray:
        """``[n_edge, 4]`` int32 (bin, lo, hi, band): the bins of each
        sub-band whose max-filter window ``[lo, hi]``, clamped to the band,
        is narrower than the full band's ``[k - sf_k, k + sf_k]`` clamped to
        ``[0, K)``. For every other bin the two filters are one."""
        rows = []
        for i, s, e in self.sub_bands:
            for k in range(s, e):
                full = (max(k - self.sf_k, 0), min(k + self.sf_k, self.n_bins - 1))
                own = (max(k - self.sf_k, s), min(k + self.sf_k, e - 1))
                if own != full:
                    rows.append((k, *own, i))
        return np.asarray(rows, np.int32).reshape(-1, 4)

    @functools.cached_property
    def mel_packed(self) -> Tuple[np.ndarray, np.ndarray]:
        """The mel filterbank packed by range for the kernel: ``[nm, 3]``
        int32 (lo, hi, offset) with ``[lo, hi)`` each filter's nonzero range,
        and the f32 weights of all ranges end to end, filter m's at
        ``offset``."""
        nz = self.mel_w != 0
        lo = np.where(nz.any(0), nz.argmax(0), 0)
        hi = np.where(nz.any(0), self.n_bins - nz[::-1].argmax(0), 0)
        off = np.concatenate([[0], np.cumsum(hi - lo)[:-1]])
        pack = np.concatenate([self.mel_w[a:b, m] for m, (a, b) in enumerate(zip(lo, hi))]
                              + [np.zeros(0, np.float32)])
        return np.stack([lo, hi, off], 1).astype(np.int32), pack.astype(np.float32)

    @functools.cached_property
    def mel_tasks(self) -> Tuple[np.ndarray, np.ndarray]:
        """The mel dots as the kernel's lanes take them: ``[n_task, 4]`` int32
        (lo, hi, offset into the packed weights, output column), a task a
        lane, and ``[n_rounds + 1]`` int32 round starts. A filter wider than
        ``MEL_TASK_BINS`` is cut into pieces; piece i of every filter is in
        round i, so that a round writes each column at most once (round 0
        sets it, later rounds add to it). Within a round the tasks are
        sorted by length, so the 32 lanes of a pass have work of one size."""
        rng, _ = self.mel_packed
        rounds = []
        for m, (lo, hi, off) in enumerate(rng.tolist()):
            for i, start in enumerate(range(lo, max(hi, lo + 1), MEL_TASK_BINS)):
                end = min(start + MEL_TASK_BINS, hi)
                while len(rounds) <= i:
                    rounds.append([])
                rounds[i].append((start, end, off + start - lo, 4 * self.nb + m))
        for tasks in rounds:
            tasks.sort(key=lambda t: t[0] - t[1])
        starts = np.cumsum([0] + [len(tasks) for tasks in rounds])
        tasks = np.asarray([t for tasks in rounds for t in tasks], np.int32).reshape(-1, 4)
        return tasks, starts.astype(np.int32)

    def on(self, device) -> Dict[str, torch.Tensor]:
        """The tables as tensors on ``device``, made once per device."""
        key = str(torch.device(device))
        if key not in self._on:
            t = {"sf_mask": self.sf_mask, "ew": self.ew,
                 "bin_band": self.bin_band.view(np.int32),
                 "edges": self.edge_windows.reshape(-1)}
            if self.mel_w is not None:
                tasks, rounds = self.mel_tasks
                t.update(mel_w=self.mel_w, mel_pack=self.mel_packed[1],
                         mel_tasks=tasks.reshape(-1), mel_rounds=rounds)
            self._on[key] = {n: torch.as_tensor(v, device=device) for n, v in t.items()}
        return self._on[key]


def _band_sf_sums(tables: NoveltyTables, sf_mask, log_prev, log_cur, d2):
    """[B, C, nb] band sums of the clamped-filter d^2: the interior read off
    the full-band ``d2`` by one mask matmul, plus exact edge runs."""
    cols = list(torch.matmul(d2, sf_mask).unbind(-1))
    for i, runs in tables.edge_runs:
        for lo, hi, t0, t1 in runs:
            pm = masked.max_pool_1d(log_prev[..., lo:hi], tables.sf_k)
            d = (log_cur[..., lo + t0:lo + t1] - pm[..., t0:t1]).clamp_min(0.0)
            cols[i] = cols[i] + (d * d).sum(dim=-1)
    return torch.stack(cols, dim=-1)


def fused_novelty_features_plain(spec: torch.Tensor, prev2: torch.Tensor, tables: NoveltyTables,
                                 *, emit_stride2: bool, emit_onset: bool,
                                 use_mel: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel: packed ``[B, C, 128]`` f32."""
    _check_mel(tables, use_mel)
    t = tables.on(spec.device)
    b, c, _ = spec.shape
    nb, nm = tables.nb, tables.nm
    ext = torch.cat([prev2, spec], dim=1)  # previous two frames + chunk
    log_ext = torch.log1p(ext.clamp_min(0.0))
    log_cur, log_prev = log_ext[:, 2:], log_ext[:, 1:-1]
    # one max filter of every previous frame serves both strides
    pm_ext = masked.max_pool_1d(log_ext[:, :-1] if emit_stride2 else log_prev, tables.sf_k)
    d = (log_cur - pm_ext[:, -c:]).clamp_min(0.0)
    zeros = spec.new_zeros((b, c, nb))
    cols = [torch.sqrt(_band_sf_sums(tables, t["sf_mask"], log_prev, log_cur, d * d)), zeros]
    if emit_stride2:
        d2 = (log_cur - pm_ext[:, :-1]).clamp_min(0.0)
        cols[1] = torch.sqrt(_band_sf_sums(tables, t["sf_mask"], log_ext[:, :-2], log_cur,
                                           d2 * d2))
    cols.append(torch.matmul(spec * spec, t["ew"]))  # (energy, hfc) interleaved per band
    if nm:
        cols.append(torch.matmul(log_cur, t["mel_w"]) if use_mel else spec.new_zeros((b, c, nm)))
    if emit_onset:
        # per-frame max-normalize, HWR L2 difference (spectral_flux.rs:116-157)
        ext_max = ext.amax(dim=-1, keepdim=True)
        cur_max, prev_max = ext_max[:, 2:], ext_max[:, 1:-1]
        cur_n = torch.where(cur_max > EPSILON, spec / cur_max.clamp_min(EPSILON), 0.0)
        prev_n = torch.where(prev_max > EPSILON, ext[:, 1:-1] / prev_max.clamp_min(EPSILON), 0.0)
        dn = (cur_n - prev_n).clamp_min(0.0)
        cols.append(torch.sqrt((dn * dn).sum(dim=-1, keepdim=True)))
    packed = torch.cat(cols, dim=-1)
    return F.pad(packed, (0, PCOLS - packed.shape[-1]))


def _check_mel(tables: NoveltyTables, use_mel: bool) -> None:
    if use_mel and tables.mel_w is None:
        raise ValueError("fused_novelty_features: use_mel needs tables with a mel filterbank")


def check_kernel_input(spec: torch.Tensor, prev2: torch.Tensor, tables: NoveltyTables,
                       use_mel: bool) -> None:
    """Raise ``ValueError`` for input the CUDA kernel does not take."""
    _check_mel(tables, use_mel)
    k = tables.n_bins
    if (spec.dim() != 3 or spec.dtype != torch.float32 or spec.shape[-1] != k
            or prev2.shape != (spec.shape[0], 2, k) or prev2.dtype != torch.float32
            or prev2.device != spec.device):
        raise ValueError(f"fused_novelty_features kernel takes f32 spec [B, C, {k}] and prev2 "
                         f"[B, 2, {k}] on one device, got {spec.dtype} {tuple(spec.shape)} and "
                         f"{prev2.dtype} {tuple(prev2.shape)} on {prev2.device}")
    if k > KERNEL_MAX_BINS or tables.nb > KERNEL_MAX_BANDS or tables.nm > KERNEL_MAX_MELS:
        raise ValueError(f"fused_novelty_features kernel takes at most {KERNEL_MAX_BINS} bins, "
                         f"{KERNEL_MAX_BANDS} bands and {KERNEL_MAX_MELS} mels; got {k}, "
                         f"{tables.nb}, {tables.nm}")
    bounds = [x for _, s, e in tables.sub_bands for x in (s, e)]
    if any(not 0 <= x <= k for x in bounds) or bounds != sorted(bounds):
        raise ValueError(f"fused_novelty_features kernel takes disjoint ascending sub-bands "
                         f"inside [0, {k}], got {tables.bands[1:]}")
    if len(tables.edge_windows) > KERNEL_MAX_EDGES:
        raise ValueError(f"fused_novelty_features kernel takes at most {KERNEL_MAX_EDGES} bins "
                         f"within sf_k of a sub-band's edge, got {len(tables.edge_windows)}")
    if use_mel and (tables.mel_packed[1].size > KERNEL_MAX_MEL_PACKED
                    or len(tables.mel_tasks[0]) > KERNEL_MAX_MEL_TASKS
                    or len(tables.mel_tasks[1]) - 1 > KERNEL_MAX_MEL_ROUNDS):
        raise ValueError(f"fused_novelty_features kernel takes mel filters whose nonzero ranges "
                         f"hold at most {KERNEL_MAX_MEL_PACKED} weights in all and "
                         f"{KERNEL_MAX_MEL_ROUNDS * MEL_TASK_BINS} each, got "
                         f"{tables.mel_packed[1].size} in all")


def kernel_smem_bytes(k: int, tile: int, n_pack: int, n_edge: int, n_task: int) -> int:
    """Dynamic shared memory of one block (``layout`` in the source): the
    tile's rows and two halo rows, each in a 16-byte aligned slot between
    four zeros on either side; the staged output rows; the packed mel
    weights; the row maxima; the band bytes; the edge windows; the mel tasks.
    The launcher sizes the block itself; at ``FRAME_TILE`` the largest tables
    ``check_kernel_input`` admits stay under ``KERNEL_MAX_SMEM``."""
    k4 = -(-k // 4) * 4
    return 4 * ((tile + 2) * (k4 + 8) + tile * PCOLS + -(-n_pack // 4) * 4
                + -(-(tile + 2) // 4) * 4 + k4 // 4 + 4 * n_edge + 4 * n_task)


def bound_ms(b: int, c: int, k: int, nb: int, nm: int, n_pack: int, sf_k: int, *,
             emit_stride2: bool, emit_onset: bool, use_mel: bool) -> Dict[str, object]:
    """The least time an H100 could take for one call, from its shapes alone.

    Bytes: ``spec``, ``prev2`` and the packed output, each moved once, over
    3.35 TB/s. Operations, counted per bin and frame as the function needs
    them at the least (each elementary function as one operation): clamp and
    log1p 2; one ``2 sf_k + 1``-wide max filter per row ``2 sf_k`` (it serves
    both strides); SuperFlux 5 per stride (subtract, clamp, square, and the
    add into the full band's and a sub-band's sum); energy and HFC 6; the
    onset flux 6 (row maximum, division, subtract, clamp, square, add); and
    per frame 2 per packed mel weight; over the 67 TFLOP/s of the f32 SIMT
    units. The kernel's instruction stream is several times the count: the
    IEEE ``log1pf`` alone is ~25 instructions."""
    n_bytes = 4 * (b * c * k + b * 2 * k + b * c * PCOLS)
    per_bin = 2 + 2 * sf_k + 5 * (2 if emit_stride2 else 1) + 6 + (6 if emit_onset else 0)
    n_ops = b * c * (k * per_bin + (2 * n_pack if use_mel else 0))
    return cuda_build.roofline(n_bytes, n_ops)


def fused_novelty_features(spec: torch.Tensor, prev2: torch.Tensor, tables: NoveltyTables, *,
                           emit_stride2: bool, emit_onset: bool, use_mel: bool) -> torch.Tensor:
    """Packed per-frame features ``[B, C, 128]`` f32 for one STFT chunk
    ``spec [B, C, K]`` f32 (invalid frames zeroed) after ``prev2 [B, 2, K]``.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if spec.device.type == "cpu":
        return fused_novelty_features_plain(spec, prev2, tables, emit_stride2=emit_stride2,
                                            emit_onset=emit_onset, use_mel=use_mel)
    if spec.device.type != "cuda":
        raise ValueError(f"fused_novelty_features: unsupported device {spec.device}")
    check_kernel_input(spec, prev2, tables, use_mel)
    b, c, k = spec.shape
    lib = cuda_build.library()
    t = tables.on(spec.device)
    spec, prev2 = spec.contiguous(), prev2.contiguous()
    out = torch.empty((b, c, PCOLS), dtype=torch.float32, device=spec.device)
    flags = int(emit_stride2) | 2 * int(emit_onset) | 4 * int(use_mel)
    mel = [t[n] for n in ("mel_tasks", "mel_rounds", "mel_pack")] if use_mel else []
    n_task, n_rounds, n_pack = (mel[0].numel() // 4, mel[1].numel() - 1, mel[2].numel()) \
        if use_mel else (0, 0, 0)
    n_edge = t["edges"].numel() // 4
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stratum_fused_novelty(
            spec.data_ptr(), prev2.data_ptr(), t["bin_band"].data_ptr(), t["edges"].data_ptr(),
            *([x.data_ptr() for x in mel] or [None] * 3), out.data_ptr(), b, c, k, tables.nb,
            tables.nm, n_edge, n_task, n_rounds, n_pack, tables.sf_k, FRAME_TILE, BLOCK_THREADS,
            flags, stream)
    cuda_build.check(rc, "fused_novelty_features")
    tracing.count_launch(fused_novelty_features)
    return out


fused_novelty_features.launches = 0


def unpack_features(packed: torch.Tensor, nb: int, nm: int, emit_stride2: bool,
                    emit_onset: bool, use_mel: bool) -> Dict[str, torch.Tensor]:
    """Split the packed ``[B, C, 128]`` output into the reducer's dict."""
    outs = {
        "superflux": packed[..., 0:nb],
        "energy": packed[..., 2 * nb:4 * nb:2],
        "hfc": packed[..., 2 * nb + 1:4 * nb:2],
    }
    if emit_stride2:
        outs["superflux2"] = packed[..., nb:2 * nb]
    if use_mel:
        outs["mel"] = packed[..., 4 * nb:4 * nb + nm]
    if emit_onset:
        outs["onset_sflux"] = packed[..., 4 * nb + nm]
    return outs

