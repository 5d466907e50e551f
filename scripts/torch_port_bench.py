#!/usr/bin/env python3
"""Measurements of the PyTorch port (``stratum_dsp_tpu_torch``) on one CUDA card.

Every figure of the port in PERF.md that ``chip_smoke.py`` does not print
comes from here. Run from the repository root on a machine with a card:

  python3 scripts/torch_port_bench.py kernels
      build the kernels (with the compiler's register report), hold kernels
      A (polyphase stage 2), B (downbeat walk), C (Viterbi decode) and D
      (fused novelty reducer, base and auxiliary variants) to their plain
      versions at the main path's shapes and time them, B and C beside an
      empty launch of their grids; ``--sweep`` also times a list of frame
      tiles (and, for D, block sizes) so that the constants in
      ``ops/polyphase.py`` and ``ops/novelty.py`` can be chosen by
      measurement.
  python3 scripts/torch_port_bench.py batches
      the default config on 40 tracks x 180 s, clean and adversarial mixes:
      a warm-up and five timed batches each, median and spread of tracks/s.
  python3 scripts/torch_port_bench.py profile
      one adversarial batch under ``torch.profiler``: device time by kernel
      and the card's busy share of the wall.
  python3 scripts/torch_port_bench.py probe
      build the kernels with ``-DSTRATUM_PROBE`` (a library of its own) and
      print, for kernels B and C on each of their inputs, the SM clock cycles
      between the phase boundaries that thread 0 of each block stamps, for
      the slowest block and the median block, beside the kernel's time.
  python3 scripts/torch_port_bench.py optin [--tracks N] [--configs a,b]
      the opt-in configurations of ``measure.OPT_IN_CONFIGS`` (HPSS onsets +
      percussive fallback + LOUDNESS; tuning compensation + exact HPCP peaks;
      log-frequency chroma) on the first N tracks (default 40) of the
      adversarial mix x 180 s: a warm-up and two timed batches each, tracks/s,
      peak device memory, launch counts, and for the HPSS config the times of
      its own stages and of one masked median filter on either axis.
  python3 scripts/torch_port_bench.py compare --parent DIR
      ``kernels`` and ``batches`` for two trees on one card in one call, each
      in a process of its own, in the order parent, change, change, parent.
      DIR is an unpacked copy of the parent commit (``git archive``);
      ``--only kernels`` leaves the batches out.

``--tree DIR`` imports the port from another checkout than this one; the
inputs and the timer are always this checkout's, those ``chip_smoke.py``
uses (``stratum_dsp_tpu_torch/measure.py``, loaded as a file of its own).
``--sweep`` sets the wrappers' tile constants from outside for each timing
and puts them back. Each mode prints the card's name and power limit first
and one JSON line per result last. Imports nothing of JAX. This is the
beginning of the port's bench: the seed mixes and the timings are here, the
exact gates are ``chip_smoke.py``'s still.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
TIMED_BATCHES = 5


def load_measure():
    """This checkout's ``measure.py`` as a module of its own, whatever tree
    ``stratum_dsp_tpu_torch`` itself is imported from."""
    spec = importlib.util.spec_from_file_location(
        "stratum_port_measure", REPO / "stratum_dsp_tpu_torch" / "measure.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def host_time_ms(fn, reps: int) -> float:
    """Host time of one call of a wrapper (checks, allocation, launch)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = 1000.0 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return ms


def run_kernels(sweep: bool) -> dict:
    import torch
    from stratum_dsp_tpu_torch.ops import cuda_build
    from stratum_dsp_tpu_torch.ops import novelty as nov
    from stratum_dsp_tpu_torch.ops import polyphase as poly

    measure = load_measure()
    cuda_time_ms, D_VARIANTS = measure.cuda_time_ms, measure.D_VARIANTS
    dev = torch.device("cuda:0")
    _, build_s = cuda_build.build(verbose=True)
    a_args, (spec, prev2, tables) = measure.kernel_inputs(dev)
    result = {"build_s": build_s}

    def time_a():
        got = poly.polyphase_stage2(*a_args)
        torch.cuda.synchronize()
        if not torch.equal(got, poly.polyphase_stage2_plain(*a_args)):
            raise SystemExit(f"kernel A is not bit-equal (FRAME_TILE {poly.FRAME_TILE})")
        return cuda_time_ms(lambda: poly.polyphase_stage2(*a_args), 50)

    def time_d(flags):
        got = nov.fused_novelty_features(spec, prev2, tables, **flags)
        torch.cuda.synchronize()
        ref = nov.fused_novelty_features_plain(spec, prev2, tables, **flags)
        scale = ref.abs().amax(dim=(0, 1)) + 1e-12
        rel = float(((got - ref).abs().amax(dim=(0, 1)) / scale).max())
        if not rel < 1e-5:
            raise SystemExit(f"kernel D is off its plain version by {rel} per column "
                             f"(FRAME_TILE {nov.FRAME_TILE})")
        return cuda_time_ms(lambda: nov.fused_novelty_features(spec, prev2, tables, **flags), 50)

    result["A_ms"] = time_a()
    result["A_host_ms"] = host_time_ms(lambda: poly.polyphase_stage2(*a_args), 50)
    result["A_plain_ms"] = cuda_time_ms(lambda: poly.polyphase_stage2_plain(*a_args), 10)
    for name, flags in D_VARIANTS.items():
        result[f"D_{name}_ms"] = time_d(flags)
        result[f"D_{name}_host_ms"] = host_time_ms(
            lambda: nov.fused_novelty_features(spec, prev2, tables, **flags), 50)
        result[f"D_{name}_plain_ms"] = cuda_time_ms(
            lambda: nov.fused_novelty_features_plain(spec, prev2, tables, **flags), 10)
    from stratum_dsp_tpu_torch.ops import downbeats, viterbi

    def exact(name, got, ref):
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise SystemExit(f"kernel {name} disagrees with its plain version")

    walk = measure.walk_inputs(dev)
    for case in ("drawn", "main"):
        args = (walk["times"], walk[f"n_beats_{case}"], walk["bar"])
        exact(f"B ({case})", downbeats.downbeat_mask(*args), downbeats.downbeat_mask_plain(*args))
        result[f"B_{case}_ms"] = cuda_time_ms(lambda: downbeats.downbeat_mask(*args), 200)
    for case, em in measure.decode_inputs(dev).items():
        exact(f"C ({case})", viterbi.viterbi_decode(em), viterbi.viterbi_decode_plain(em))
        result[f"C_{case}_ms"] = cuda_time_ms(lambda: viterbi.viterbi_decode(em), 200)
    if hasattr(cuda_build.library(), "stratum_empty_launch"):
        result["B_empty_launch_ms"] = measure.empty_launch_ms(
            40, downbeats.BLOCK_THREADS, walk["times"].shape[1] * downbeats.SMEM_BYTES_PER_SLOT)
        result["C_empty_launch_ms"] = measure.empty_launch_ms(
            40, viterbi.BLOCK_THREADS, em.shape[1] * viterbi.SMEM_BYTES_PER_FRAME)
    if sweep:
        # what each part of kernel D costs: the variants with one part off
        for name, s2, onset, mel in (("no_mel", False, False, False),
                                     ("stride2_only", True, False, True),
                                     ("onset_only", False, True, True)):
            result[f"D_{name}_ms"] = time_d(dict(emit_stride2=s2, emit_onset=onset, use_mel=mel))
        kept = poly.FRAME_TILE
        for tile in (16, 32, 48, 64, 112, 128, 224):
            poly.FRAME_TILE = tile
            result[f"A_ms_tile{tile}"] = time_a()
        poly.FRAME_TILE = kept
        kept = nov.FRAME_TILE, nov.BLOCK_THREADS
        # the escalation's hop-256 pass runs the auxiliary variant on the
        # gathered rows: 12 of 40 on the adversarial mix
        sub = (spec[:12].contiguous(), prev2[:12].contiguous(), tables)
        for tile, threads in ((6, 256), (8, 256), (10, 384), (12, 448), (13, 480), (14, 512),
                              (16, 512), (30, 1024)):
            nov.FRAME_TILE, nov.BLOCK_THREADS = tile, threads
            for name, flags in D_VARIANTS.items():
                result[f"D_{name}_ms_tile{tile}_threads{threads}"] = time_d(flags)
            result[f"D_aux_B12_ms_tile{tile}_threads{threads}"] = cuda_time_ms(
                lambda: nov.fused_novelty_features(*sub, **D_VARIANTS["aux"]), 50)
        nov.FRAME_TILE, nov.BLOCK_THREADS = kept
    return result


def run_batches() -> dict:
    import torch
    import stratum_dsp_tpu_torch as port

    dev = torch.device("cuda:0")
    measure = load_measure()
    mixes, lengths = measure.real_size_mixes(dev)
    result = {}
    for name, batch in mixes.items():
        walls = []
        for i in range(TIMED_BATCHES + 1):  # the first is the warm-up
            t0 = time.perf_counter()
            out = port.analyze_batch(batch, lengths, port.AnalysisConfig(), device=dev)
            torch.cuda.synchronize()
            if i:
                walls.append(time.perf_counter() - t0)
        rates = sorted(measure.B_REAL / w for w in walls)
        result[name] = {"median_tracks_per_s": float(np.median(rates)), "min": rates[0],
                        "max": rates[-1], "walls_s": [round(w, 4) for w in walls],
                        "escalated": int(out["multi_res_used"].sum())}
    return result


def run_opt_in(tracks: int, names) -> dict:
    import torch
    from stratum_dsp_tpu_torch.ops import masked

    dev = torch.device("cuda:0")
    measure = load_measure()
    mixes, lengths = measure.real_size_mixes(dev)
    # trap-zone kicks first, so that a small batch still escalates and falls back
    batch, lengths = mixes["adversarial"].flip(0)[:tracks].contiguous(), lengths[:tracks]
    result = {"tracks": tracks}
    for name in names:
        cfg = measure.opt_in_config(name)
        run = measure.timed_batches(batch, lengths, cfg, dev, 2)
        out = run.pop("out")
        result[name] = dict(run, tracks_per_s=tracks / float(np.median(run["walls_s"])),
                            bpm=[round(x, 2) for x in out["bpm"].tolist()],
                            percussive_triggered=int(out["percussive_triggered"].sum()),
                            percussive_used=int(out["percussive_used"].sum()))
        del out
        if name == "hpss":
            result[name]["stages"] = measure.hpss_stage_times(batch, lengths, cfg, dev)
            # one median of either axis of a [tracks, F, 1025] spectrogram
            frames = (batch.shape[1] - 2048) // 512 + 1
            x = torch.rand((tracks, frames, 1025), device=dev)
            counts = torch.full((tracks, 1), frames, device=dev)
            bins = torch.full((tracks, 1), 1025, device=dev)
            result[name]["median_time_axis_ms"] = measure.cuda_time_ms(
                lambda: masked.masked_median_filter_1d(x.transpose(1, 2), counts, cfg.hpss_margin),
                1)
            result[name]["median_freq_axis_ms"] = measure.cuda_time_ms(
                lambda: masked.masked_median_filter_1d(x, bins, cfg.hpss_margin), 1)
            del x
        torch.cuda.empty_cache()
    return result


def run_profile() -> dict:
    import torch
    import stratum_dsp_tpu_torch as port
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda:0")
    measure = load_measure()
    mixes, lengths = measure.real_size_mixes(dev)
    batch = mixes["adversarial"]
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        port.analyze_batch(batch, lengths, port.AnalysisConfig(), device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        port.analyze_batch(batch, lengths, port.AnalysisConfig(), device=dev)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    rows = [(e.key, getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0),
             e.count) for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)]
    rows.sort(key=lambda r: -r[1])
    total_ms = sum(r[1] for r in rows) / 1000.0
    return {"unprofiled_walls_s": [round(w, 4) for w in walls[1:]],
            "profiled_wall_s": round(profiled_wall, 4), "device_ms": total_ms,
            "busy_share_of_unprofiled_wall": total_ms / 1000.0 / float(np.median(walls[1:])),
            "port_kernels": [{"name": n[:60], "ms": t / 1000.0, "count": c} for n, t, c in rows
                             if any(x in n for x in ("polyphase_stage2", "fused_novelty",
                                                     "downbeat_mask", "viterbi"))],
            "top_kernels": [{"name": n[:80], "ms": t / 1000.0, "count": c}
                            for n, t, c in rows[:10]]}


def run_probe() -> dict:
    """Cycles per phase of kernels B and C, from the stamps of a probe build."""
    import ctypes

    import torch
    from stratum_dsp_tpu_torch.ops import cuda_build, downbeats, viterbi

    measure = load_measure()
    cuda_time_ms = measure.cuda_time_ms
    cuda_build.NVCC_FLAGS = (*cuda_build.NVCC_FLAGS, "-DSTRATUM_PROBE")
    for name in ("stratum_probe_downbeat", "stratum_probe_viterbi"):
        cuda_build._SIGNATURES[name] = ([ctypes.c_void_p], ctypes.c_int)
    lib = cuda_build.library()
    dev = torch.device("cuda:0")

    def phases(read, names, call):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        stamps = np.zeros((64, 8), np.int64)
        cuda_build.check(read(stamps.ctypes.data), "probe")
        stamps = stamps[:measure.B_REAL, :len(names) + 1]
        stamps = stamps[stamps[:, -1] > 0]  # a block that returned early stamped no end
        cycles = np.diff(stamps, axis=1)
        slowest = int(np.argmax(stamps[:, -1] - stamps[:, 0]))
        return {"phases": names, "slowest_block_cycles": cycles[slowest].tolist(),
                "median_block_cycles": np.median(cycles, axis=0).tolist(),
                "ms": cuda_time_ms(call, 200)}

    result = {}
    walk = measure.walk_inputs(dev)
    for case in ("drawn", "main"):
        args = (walk["times"], walk[f"n_beats_{case}"], walk["bar"])
        result[f"B_{case}"] = phases(lib.stratum_probe_downbeat,
                                     ["stage", "successor sets", "walk"],
                                     lambda: downbeats.downbeat_mask(*args))
    for case, em in measure.decode_inputs(dev).items():
        result[f"C_{case}"] = phases(
            lib.stratum_probe_viterbi,
            ["stage", "forward", "backpointers", "backtrack", "write out"],
            lambda: viterbi.viterbi_decode(em))
    return result


def run_compare(parent: Path, timeout: int, modes) -> None:
    for label, tree in (("parent", parent), ("change", REPO), ("change", REPO),
                        ("parent", parent)):
        for mode in modes:
            proc = subprocess.run([sys.executable, __file__, mode, "--tree", str(tree)],
                                  capture_output=True, text=True, timeout=timeout, check=False)
            last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
            if proc.returncode != 0:
                print(f"{label} {mode} failed ({proc.returncode}):\n{proc.stdout[-2000:]}\n"
                      f"{proc.stderr[-4000:]}", flush=True)
                raise SystemExit(1)
            print(f"{label} {mode}: {last}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=["kernels", "batches", "profile", "probe", "optin",
                                         "compare"])
    parser.add_argument("--tracks", type=int, default=40, help="optin: tracks in the batch")
    parser.add_argument("--configs", default="hpss,tuned-exact,log-frequency",
                        help="optin: comma-separated names of measure.OPT_IN_CONFIGS")
    parser.add_argument("--tree", type=Path, default=REPO, help="checkout to import the port from")
    parser.add_argument("--parent", type=Path, help="unpacked parent commit (compare)")
    parser.add_argument("--sweep", action="store_true", help="kernels: also time other tiles")
    parser.add_argument("--only", choices=["kernels", "batches"],
                        help="compare: this mode alone instead of both")
    parser.add_argument("--timeout", type=int, default=600, help="compare: seconds per process")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this script needs a CUDA card")
        return 2
    print(card(), flush=True)
    if args.mode == "compare":
        if args.parent is None:
            parser.error("compare needs --parent")
        run_compare(args.parent.resolve(), args.timeout,
                    (args.only,) if args.only else ("kernels", "batches"))
        return 0
    sys.path.insert(0, str(args.tree.resolve()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"kernels": lambda: run_kernels(args.sweep), "batches": run_batches,
              "profile": run_profile, "probe": run_probe,
              "optin": lambda: run_opt_in(args.tracks, args.configs.split(","))}[args.mode]()
    print(json.dumps({"mode": args.mode, "tree": str(args.tree), "card": card(), **result}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
