"""Device-mesh scale-out for the analysis pipeline (port of
``stratum_dsp_tpu/parallel/mesh.py``).

The reference's only parallelism is a thread pool over independent files
(examples/analyze_batch.rs:239-262). The two axes of the JAX package's mesh
map onto PyTorch devices as follows:

* ``tracks`` axis: the padded ``[B, T]`` batch is cut into contiguous
  shards of ``B / n_tracks`` rows, and each shard runs the whole pipeline on
  its own device (the JAX package's ``P("tracks")``). Chunk sizes that
  depend on the batch are computed from the global B, as the JAX package's
  one SPMD program sees it.
* ``time`` axis: long tracks are cut into contiguous sample blocks (context
  parallelism, the JAX package's ``P("tracks", "time")``): each position of
  a shard's row holds only its own block (``parallel.timeblocks.
  TimeBlocks``). Every sample-domain stage (normalization, silence RMS and
  trim shift, onset RMS, the BPM, hop-256, HPSS and key STFTs) runs block by
  block: each block's device takes its neighbours' edge samples, runs the
  same reducer as the unsharded path, and the per-frame features come back
  concatenated on the shard's first device, where everything downstream
  runs. Activated by passing a 2-D mesh.

A ``Mesh`` is a grid of devices in one process, as a JAX ``Mesh`` is, and a
device may repeat: ``[cuda:0] * 4`` as a (2, 2) mesh really cuts each track
into blocks and each batch into shards on one card, and ``[cpu] * 8`` runs a
mesh on the CPU. Shards on distinct devices run in one host thread each, so
that one shard's host reads do not stall the others; on a repeated device
they run one after another. Several processes join through
``parallel.multihost``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..analysis.pipeline import PipelineCaps, analyze_batch_arrays
from ..config import AnalysisConfig

TIME_QUANTUM = 1024  # lcm of every frontend hop (256/512/1024) used on T


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of ``torch.device``s (a numpy object array) with one name per
    axis: ``("tracks",)`` or ``("tracks", "time")``. ``shape`` maps each
    name to its size, as ``jax.sharding.Mesh.shape`` does."""

    devices: np.ndarray
    axis_names: tuple

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device grid needs as many axis names, "
                             f"got {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def grid(self) -> np.ndarray:
        """The devices as ``[n_tracks, n_time]`` (one column on a 1-D mesh)."""
        return self.devices.reshape(self.devices.shape[0], -1)

    def row(self, i: int) -> "Mesh":
        """Tracks shard ``i``'s devices as a ``(1, n_time)`` mesh."""
        return Mesh(self.grid()[i:i + 1], ("tracks", "time"))


def make_mesh(devices: Optional[Sequence] = None, n_time: int = 1) -> Mesh:
    """1-D ``(tracks,)`` mesh, or 2-D ``(tracks, time)`` when n_time > 1.

    ``devices`` defaults to every visible CUDA device and raises
    ``RuntimeError`` where there is none: a mesh on the CPU names its
    devices (``[torch.device("cpu")] * 8``). Devices may repeat."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; pass devices "
                               '(e.g. [torch.device("cpu")] * 8) to build a mesh on the CPU')
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    if n_time <= 1:
        return Mesh(grid, ("tracks",))
    if len(grid) % n_time:
        raise ValueError(f"{len(grid)} devices are not divisible by n_time={n_time}")
    return Mesh(grid.reshape(len(grid) // n_time, n_time), ("tracks", "time"))


def pad_batch_for_mesh(samples, mesh: Mesh):
    """Right-pad T to a multiple of n_time * TIME_QUANTUM (no-op on 1-D);
    a numpy array or a tensor, returned as the same kind."""
    m = mesh.shape.get("time", 1) * TIME_QUANTUM
    t = samples.shape[1]
    t_pad = -(-t // m) * m
    if t_pad == t:
        return samples
    if torch.is_tensor(samples):
        return F.pad(samples, (0, t_pad - t))
    out = np.zeros((samples.shape[0], t_pad), samples.dtype)
    out[:, :t] = samples
    return out


def map_on_devices(fn: Callable, jobs: Sequence, devices: Sequence) -> list:
    """``[fn(job) for job in jobs]``, job ``k`` on ``devices[k]``: in one
    host thread per job when the devices are distinct CUDA devices (each
    thread with its device current), else one after another. Every result
    is read, so a job's exception is raised here."""
    keys = [str(torch.device(d)) for d in devices]
    if len(jobs) < 2 or len(set(keys)) < len(keys) or any(
            torch.device(d).type != "cuda" for d in devices):
        return [fn(job) for job in jobs]

    def run(job, device):
        with torch.cuda.device(device), torch.no_grad():
            return fn(job)

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = [pool.submit(run, job, dev) for job, dev in zip(jobs, devices)]
        return [f.result() for f in futures]


def check_tracks_split(b: int, mesh: Mesh) -> int:
    """Rows per tracks shard; raises unless B divides by the tracks size
    (the JAX package's ``P("tracks")`` requires it)."""
    n = mesh.shape["tracks"]
    if b % n:
        raise ValueError(f"a batch of {b} tracks does not divide over a tracks axis of {n}")
    return b // n


def analyze_batch_sharded(samples, lengths, cfg: AnalysisConfig, sample_rate: int,
                          caps: PipelineCaps, mesh: Mesh):
    """Run the full pipeline sharded over the mesh.

    1-D mesh: the batch is sharded over ``tracks``. 2-D mesh: each tracks
    shard's samples are cut into ``time`` blocks with the time-block
    frontends active (pad T with ``pad_batch_for_mesh`` first); a host
    batch is cut on the host, and each mesh position receives only its own
    block (``timeblocks.TimeBlocks``). Numpy arrays or tensors in (on the
    host or on a device of the mesh); the result dict lies on the mesh's
    first device."""
    if not torch.is_tensor(samples) and "time" not in mesh.shape:
        samples = torch.as_tensor(np.asarray(samples, np.float32))
    if not torch.is_tensor(lengths):
        lengths = torch.as_tensor(np.asarray(lengths))
    with torch.no_grad():
        return analyze_batch_arrays(samples, lengths, cfg, sample_rate, caps, "", mesh)


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> None:
    """Build an n-device mesh, run the FULL analysis sharded over it and
    check the outputs' shapes (the JAX package's multi-chip dry run).

    Exercises both shardings: the 1-D tracks mesh on tiny shapes, then the
    2-D ``(tracks, time)`` mesh with production caps on long kick tracks
    (``DRYRUN_SECONDS``, default 180). On fewer cards than ``n_devices`` the
    mesh repeats them (one card: ``cuda:0`` n times); ``device_type="cpu"``
    runs it on the CPU."""
    from ..testing import SAMPLE_RATE, kick_patterns

    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device is available")
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(n_devices)]
    else:
        devices = [torch.device(device_type)] * n_devices

    cfg = AnalysisConfig()  # full default pipeline incl. multi-res escalation
    sr = SAMPLE_RATE

    # 1-D tracks mesh: full default pipeline, one track per device
    caps_small = PipelineCaps(max_onsets=128, max_beats=128, seg_beat_cap=16, max_segments=6)
    t = 5 * 8192
    rng = np.random.default_rng(0)
    samples = (rng.standard_normal((n_devices, t)) * 0.1).astype(np.float32)
    samples[:, :: t // 8] += 0.9
    lengths = np.full((n_devices,), t, np.int64)
    out = analyze_batch_sharded(samples, lengths, cfg, sr, caps_small, make_mesh(devices))
    bpm = out["bpm"].cpu().numpy()
    if bpm.shape != (n_devices,):
        raise RuntimeError(f"dryrun 1-D: bpm has shape {bpm.shape}")
    print(f"dryrun 1-D tracks mesh OK: {n_devices} devices, bpm={np.round(bpm, 2)}")

    # 2-D (tracks, time) mesh: production caps, long tracks
    n_time = 2 if n_devices % 2 == 0 else 1
    if n_time > 1:
        secs = float(os.environ.get("DRYRUN_SECONDS", "180"))
        mesh2 = make_mesh(devices, n_time=n_time)
        b2 = n_devices // n_time
        bpms = np.linspace(85.0, 168.0, b2)
        samples2 = pad_batch_for_mesh(kick_patterns(bpms, secs), mesh2)
        lengths2 = torch.full((b2,), int(secs * sr), dtype=torch.int64)
        out2 = analyze_batch_sharded(samples2, lengths2, cfg, sr, PipelineCaps(), mesh2)
        got = out2["bpm"].cpu().numpy()
        err = np.abs(got - bpms)
        fam = np.minimum.reduce([err, np.abs(got - 2 * bpms), np.abs(got - 0.5 * bpms)])
        if got.shape != (b2,):
            raise RuntimeError(f"dryrun 2-D: bpm has shape {got.shape}")
        print(f"dryrun 2-D (tracks={b2}, time={n_time}) mesh OK: {secs:.0f}s tracks, "
              f"production caps, bpm={np.round(got, 2)}, family_ok={fam < 2.0}")
