"""Several processes, one tracks axis: the multi-host runbook (port of
``scripts/multihost_smoke.py``).

Two processes join by ``torch.distributed.init_process_group``; each builds
the mesh of its own devices (four) and passes only its own rows to
``analyze_batch_sharded``, which stands for the JAX package's
``make_array_from_process_local_data`` over one global tracks mesh. The
result dicts are all-gathered along the batch axis (``gather_results``), so
every process ends with the global batch's results. Each process checks its
rows against the unsharded port on the same rows, and every gathered BPM
against its seed.

Collectives: gloo on the CPU; on a machine with a card per process, NCCL,
each rank on its own card; on one card both ranks run on ``cuda:0`` and
gather CPU copies over gloo (NCCL refuses two ranks on one GPU).

Run: python -m stratum_dsp_tpu_torch.parallel.multihost [--device cpu|cuda]
(the parent spawns the two workers, which are re-invocations with --rank;
it prints ``multihost smoke: OK`` when both pass).
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

N_PROC = 2
LOCAL_DEVICES = 4
SECONDS = 4.0
SAMPLE_RATE = 44100
TIMEOUT_S = 600  # the workers' wall, joining included


def gather_results(out: dict) -> dict:
    """Every rank's result dict, all-gathered and concatenated along the
    batch axis in rank order (the same shapes on every rank). Over gloo the
    tensors travel as CPU copies, over NCCL from the rank's card."""
    comm = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))
    gathered = {}
    for k, v in out.items():
        x = v.to(comm)
        x = (x.to(torch.uint8) if v.dtype == torch.bool else x).contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x)
        y = torch.cat(parts)
        gathered[k] = y.to(torch.bool) if v.dtype == torch.bool else y
    return gathered


def _worker(rank: int, device_type: str, port: int) -> int:
    import stratum_dsp_tpu_torch as port_pkg
    from stratum_dsp_tpu_torch.parallel.mesh import analyze_batch_sharded, make_mesh
    from stratum_dsp_tpu_torch.testing import assert_outputs_match, kick_pattern

    torch.set_num_threads(2)
    backend = "gloo"
    dev = torch.device("cpu")
    if device_type == "cuda":
        own_card = torch.cuda.device_count() >= N_PROC
        dev = torch.device("cuda", rank if own_card else 0)
        torch.cuda.set_device(dev)
        backend = "nccl" if own_card else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=N_PROC, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = make_mesh([dev] * LOCAL_DEVICES)  # this process's part of the tracks axis
        bpms = np.linspace(90.0, 160.0, N_PROC * LOCAL_DEVICES)
        lo = rank * LOCAL_DEVICES
        # each process makes only ITS tracks (process-local data)
        samples = np.stack([kick_pattern(x, SECONDS) for x in bpms[lo:lo + LOCAL_DEVICES]])
        lengths = np.full((LOCAL_DEVICES,), samples.shape[1], np.int64)
        cfg = port_pkg.AnalysisConfig()
        caps = port_pkg.PipelineCaps(max_onsets=256, max_beats=256, seg_beat_cap=16,
                                     max_segments=6)
        out = analyze_batch_sharded(samples, lengths, cfg, SAMPLE_RATE, caps, mesh)
        ref = port_pkg.analyze_batch(samples, lengths, cfg, SAMPLE_RATE, caps, device=dev)
        ok = True
        try:
            assert_outputs_match(ref, out)
        except AssertionError as exc:
            print(f"[rank {rank}] sharded rows differ from the unsharded run: {exc}", flush=True)
            ok = False
        everything = gather_results(out)
        got = everything["bpm"].cpu().numpy()
        mine = everything["bpm"][lo:lo + LOCAL_DEVICES].cpu()
        if got.shape != bpms.shape or not torch.equal(mine, out["bpm"].cpu()):
            print(f"[rank {rank}] gathered bpm {got} does not hold this rank's rows", flush=True)
            ok = False
        fam = np.minimum.reduce([np.abs(got - bpms), np.abs(got - 2 * bpms),
                                 np.abs(got - 0.5 * bpms)])
        for i in range(lo, lo + LOCAL_DEVICES):
            print(f"[rank {rank}] track {i}: bpm={got[i]:.2f} (want {bpms[i]:.1f}) "
                  f"{'OK' if fam[i] < 2.0 else 'MISS'}", flush=True)
        ok &= bool((fam < 2.0).all())
        print(f"[rank {rank}] {backend} over {dev}, {len(got)} tracks gathered", flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                   help="where the workers run (default: the card)")
    p.add_argument("--port", type=int, default=0, help="rendezvous port (default: a free one)")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        return _worker(args.rank, args.device, args.port)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("multihost: --device cuda but no CUDA device is available", file=sys.stderr)
        return 2
    port = args.port or free_port()
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x]))
    procs = [subprocess.Popen([sys.executable, "-m", "stratum_dsp_tpu_torch.parallel.multihost",
                               "--device", args.device, "--port", str(port), "--rank", str(r)],
                              env=env)
             for r in range(N_PROC)]
    rc = 0
    try:
        for proc in procs:
            rc |= proc.wait(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc = 1
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print("multihost smoke:", "OK" if rc == 0 else "FAILED", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
