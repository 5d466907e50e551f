#!/usr/bin/env python3
"""Quickest proof that the PyTorch port of stratum_dsp_tpu runs on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``stratum_dsp_tpu_torch/csrc`` and
drives the port (``stratum_dsp_tpu_torch.analyze_batch``) in these phases,
one line each:

1. device: a CUDA card is required; prints its name and power limit;
2. build: one ``nvcc`` per source for sm_90a, all at once, with the time;
3-6. each kernel against its plain PyTorch version on the card at the main
   path's shapes, with both times and the kernel's bound (the least time the
   card could take: bytes over 3.35 TB/s or operations over 67 TFLOP/s,
   whichever is larger): A (polyphase stage 2) bit for bit, B (downbeat
   walk) and C (Viterbi decode, with rows that underflow) exactly, D (fused
   novelty reducer, base and auxiliary variants) within 1e-5 of each output
   group's largest value; A and D also at ragged shapes (short and uneven
   frame counts, bins at a block's edge, small batches, mel and bands off).
   B and C are bound by latency, so each is timed on two inputs (B: beat
   counts drawn from the whole row, and those of 180 s tracks; C: emissions
   that die out early, and emissions that keep every frame alive) beside an
   empty launch of its grid, the floor it can approach; C's backtrack scan is
   also held to the plain backtrack on random backpointers; B and C are also
   held exactly to their plain versions past shared memory, at a batch of
   whole two-hour mixes (``[8, 115200]`` walk slots, ``[8, 36001]`` beat
   slots: their long paths), with times, bounds and empty launches;
7. fixture batches through the port on the CPU (``device="cpu"``, plain
   versions) and on the card (the default device, kernels), compared output
   by output
   (``stratum_dsp_tpu_torch.testing.assert_outputs_match``): the slice batch
   under ``SLICE_CONFIG``, and under the default config kicks that take
   every branch of the multi-resolution escalation;
8. 40 tracks x 180 s at 44.1 kHz with the default capacities under
   ``SLICE_CONFIG``: one counted and gated batch after a warm-up;
9-10. the same size under the default ``AnalysisConfig``, for the clean mix
   (32 kicks + 8 C-major scales) and the adversarial mix (28 core kicks, 12
   in the escalation's trap zones): a warm-up, then three timed batches
   (median and spread of tracks/s); the first is the one whose kernel
   launches are counted and whose outputs are gated (exact BPM on core
   kicks, family-exact on trap kicks, scales in C, beats and downbeats on
   every track, the escalation used on the adversarial mix); then the
   adversarial batch's cumulative stage times (``analysis.timing.stage_timings``);
11. the file path: the adversarial mix written as 40 16-bit WAVs into a
   temporary directory, through ``cli.analyze_batch.main`` (twice: the first
   run warms the 240 s bucket's shape up) and ``cli.analyze_file.main`` on the
   card, the JSONL held to the same gates and to ``decode_results`` of the
   same samples analyzed in memory; decode seconds, analyze seconds and
   tracks/s from files; then one opt-in flag (``--enable-key-ensemble true``)
   through ``cli.analyze_file``, held to the same track analyzed in memory;
12. the scale-out (``parallel/``): the 2-D (tracks 2 x time 2) mesh of
   ``cuda:0`` against the same mesh of the CPU on four kicks, outputs held to
   each other, and so under LOUDNESS on four silence sandwiches from numpy
   (one's leading silence crosses the block edge), the card's run under
   ``testing.AllocationRecorder``: no tensor allocated there may be longer
   than a block and its context; at the real size (the adversarial mix, T
   padded for a time axis of 2) the 1-D mesh of 2 held to the unsharded run
   on the same batch, and the 2-D (1 x 2) mesh, its batch taken from host
   memory and cut into blocks there, held to it on every output but the
   key's (its key STFT is the direct DFT of the JAX package's time blocks:
   kernel A is not launched there), its key to its own second run, the clean
   mix's scales in C; what each 2-D position holds (gated: its block and no
   more), the peak device memory and the walls of the three runs, the
   launches of each mesh run, the key detection's time in time blocks and
   unsharded; then two processes on one tracks axis
   (``parallel.multihost --device cuda``);
13. the synthetic battery: the 338 tracks of ``testing/battery.py`` as
   16-bit WAVs in a temporary directory (rendered in one process per CPU
   core), through the port's battery runner
   (``validation.run_battery``, batch 16, the 36 s bucket) on the card with
   the ``--tc``, ``--bcf``, ``--ra`` and ``--codec`` passes, held to the
   committed ``ACCURACY_r5.json``: every track analyzed, each family's +-2 BPM
   and key hits within one track of it, the overall hits within three, the
   overall beat and downbeat F within 0.01, every kernel launched; it prints
   the tracks whose hit or miss differs from the file's and the seconds of
   each step.

Between them, the opt-in paths:

* the windowed median (``ops/masked.py:window_median``, a kernel with no TPU
  counterpart) after phase 6: both passes of an HPSS iteration at the hpss
  cell's shape ``[16, 15500, 1025]``, the chroma smoothing's
  ``[40, 3900, 12]`` and the general path of a wide window, each bit for bit
  against its plain version (the ``torch.sort`` over unfolded windows, whose
  time is the yardstick), with the kernel's time and bound;
* the HPCP of the bisection peak pick (``ops/hpcp.py:hpcp_bisect``, a kernel
  with no TPU counterpart) after the windowed median: a default key chunk's
  ``[40, 183, 931]`` and a single request's ``[1, 512, 931]`` rows, timed
  beside the plain version and the bound, and rows with ties, fewer peaks
  than K, no peaks, bf16, whitening, per-track matrices, the bass band and a
  band past 2048 bins, each within 1e-6 of the plain version; its launches a
  key STFT chunk: one, two under the bass blend, none under exact peaks;
* the direct windowed DFT's magnitudes (``ops/stft.py:stft_magnitude``, a
  kernel with no TPU counterpart) after the HPCP: the base BPM chunk
  ``[40, 256, 2048]`` at hop 512 and the escalation's ``[12, 256, 2048]`` at
  hop 256, timed beside the plain version (unfold, bf16 rounding, cuBLAS's
  f32 product, magnitude and mask) and the bound, and a halo, rows ending
  inside the chunk, a chunk past every row's end and the 2-D mesh's key shape
  (8192 samples, 931 bins), each held to an f64 DFT of the same bf16-rounded
  operands: at most 4 times the plain version's error plus 1e-6 of the
  frame's norm;
* stage 1 of the polyphase key STFT (``ops/stft.py:poly_block_dft``, a
  kernel with no TPU counterpart) after the direct DFT: a default key chunk
  ``[40, 240, 512]`` against 2048 columns and the log-frequency width's
  8448, timed beside the plain version (block slice, bf16 rounding, cuBLAS's
  f32 product, cast) and the bound, and the hpss cell's ``[16, 512]``, a
  single request's ``[1, 560]`` and a later chunk of unaligned rows, each
  element within one bf16 ulp of the plain version's or, near zero, within
  1e-6 of the block's norm times the column's, with the count of elements
  that differ and that differ by more than one ulp; its launches in a default
  batch: one a key STFT chunk, 81;

* kernel A at the log-frequency shape (every bin kept: ``keep = 4097``,
  ``KP = 4224``) at B = 40 and at ragged batches, bit for bit, and kernel D's
  auxiliary variant over a whole 180 s track ``[40, 15500, 1025]`` in one
  launch, within 1e-5, held to its plain version a slab of frames at a time
  (after phases 3 and 6);
* three opt-in configs at the real size on the adversarial mix
  (``measure.OPT_IN_CONFIGS``: HPSS onsets + percussive fallback + LOUDNESS
  normalization; tuning compensation + exact HPCP peaks; log-frequency
  chroma), each a warm-up and timed batches held to the default gates and to
  the launch counts its config implies (log-frequency also to 4097 key STFT
  bins a pass, ``key_stft_bins``, and A's 81 launches), with tracks/s, peak
  device memory and stage times (after phase 10);
* a fixture batch on the CPU and on the card under configs that together
  switch on every opt-in branch (before phase 11).

Then one JSON line with the kernels, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
result line. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
TIMED_BATCHES = 3  # host-side gaps make single batches spread by ~20%
# kernels B and C as one thread per track walked them (NVIDIA H100 80GB HBM3,
# 700 W, on the inputs this script still times first), for the phase text
EARLIER_MS = {"downbeat_mask": 0.0854, "viterbi_decode": 0.0642}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def bound_text(bound: dict, ms: float) -> str:
    """'bound 0.0142 ms by bytes (4.3% of it reached)'."""
    return (f"bound {bound['bound_ms']:.6f} ms by {bound['bound_by']} "
            f"({100.0 * bound['bound_ms'] / ms:.1f}% of it reached)")


# ACCURACY_r5.json was measured on a TPU v5e. Where the JAX package itself,
# run on the CPU, scores a family otherwise, the difference is the TPU's
# arithmetic: the card is held to r5 plus that offset. Measured by the whole
# battery through the JAX package and the port on the CPU
# (tests/test_torch_battery.py, slow, which pins these offsets): with tuning
# compensation the JAX package gets 39 of the 48 +-30-cent tracks right, as
# the port does on the CPU and on the card, where r5 has 41 (the
# compensator's clamp is 0.08 semitones: at 30 cents the key rides on the
# last digits of the chroma)
R5_TPU_OFFSETS = {"key_detuned_tc": {"key": -2}}


def hits(scores: dict) -> dict:
    """A summary entry's +-2 BPM and key hits as track counts."""
    return {"bpm": round(scores["bpm_acc_2"] * scores["n_bpm"]) if "n_bpm" in scores else None,
            "key": round(scores["key_acc"] * scores["n_key"]) if "n_key" in scores else None}


def battery_phase(port, card: str) -> tuple:
    """Phase 13: the synthetic battery on the card against ACCURACY_r5.json
    (measured on a TPU v5e by the JAX package's runner). Returns the phase's
    seconds and the kernels' launches during the runner's run."""
    import torch
    from stratum_dsp_tpu_torch.io.decode import ffmpeg_available
    from stratum_dsp_tpu_torch.testing.battery import battery_specs
    from stratum_dsp_tpu_torch.validation import run_battery

    t_phase = time.perf_counter()
    r5 = json.loads((REPO / "ACCURACY_r5.json").read_text())
    specs = battery_specs()
    workers = os.cpu_count() or 1
    with tempfile.TemporaryDirectory(prefix="stratum_battery_") as tmp:
        t0 = time.perf_counter()
        synth = run_battery.synthesize_corpus(specs, Path(tmp), workers=workers)
        synth_wall = time.perf_counter() - t0
        port.reset_launch_counts()
        with contextlib.redirect_stderr(io.StringIO()) as log:
            summary, steps = run_battery.run(
                ["--wav-dir", tmp, "--out", str(Path(tmp) / "results" / "battery.csv"),
                 "--batch-size", "16", "--tc", "--bcf", "--ra", "--codec"])
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in port.KERNELS}
    if Path(tmp).exists():
        fail(f"the temporary directory {tmp} was not removed")
    codec_skipped = not ffmpeg_available()
    if codec_skipped != ("codec pass skipped: ffmpeg unavailable" in log.getvalue()):
        fail(f"the codec pass did not say whether it ran: ffmpeg available "
             f"{not codec_skipped}; log {log.getvalue()[-2000:]}")

    fams = summary["families"]
    passes = {"battery": 338, "battery_tc": 96, "battery_bcf": 8, "battery_ra": 194}
    analyzed = {k: steps[k]["analyzed"] for k in passes}
    codec = ("_mp3", "_ogg", "_wavslice")
    off_by = {}  # family -> (bpm hits, key hits) of the card minus r5's
    for fam, want in r5["families"].items():
        if fam.endswith(codec) and codec_skipped:
            continue
        got = hits(fams.get(fam, {"n": 0}))
        offset = R5_TPU_OFFSETS.get(fam, {})
        off_by[fam] = {k: (None if v is None or got[k] is None else got[k] - v - offset.get(k, 0))
                       for k, v in hits(want).items() if v is not None}
    overall_off = {k: hits(summary["overall"])[k] - v for k, v in hits(r5["overall"]).items()}
    grid_off = {k: summary["overall"][k] - r5["overall"][k] for k in ("beat_f", "downbeat_f")}
    moved = {
        "bpm now missed": sorted({m["name"] for m in summary["bpm_misses"]}
                                 - {m["name"] for m in r5["bpm_misses"]}),
        "bpm now hit": sorted({m["name"] for m in r5["bpm_misses"]}
                              - {m["name"] for m in summary["bpm_misses"]}),
        "key now missed": sorted({m["name"] for m in summary["key_misses"]}
                                 - {m["name"] for m in r5["key_misses"]}),
        "key now hit": sorted({m["name"] for m in r5["key_misses"]}
                              - {m["name"] for m in summary["key_misses"]}),
    }
    gates = {
        "every track analyzed": analyzed == passes,
        "families within one track of r5 (with R5_TPU_OFFSETS)": all(
            v is not None and abs(v) <= 1 for d in off_by.values() for v in d.values()),
        "overall within three tracks of r5": all(abs(v) <= 3 for v in overall_off.values()),
        "beat_f and downbeat_f within 0.01 of r5": all(abs(v) <= 0.01
                                                       for v in grid_off.values()),
        "every kernel launched": all(v > 0 for v in launches.values()),
    }
    runs = {k: v for k, v in steps.items() if k.startswith("battery")}
    n_analyses = sum(r["tracks"] for r in runs.values())
    wall = sum(r["wall_s"] for r in runs.values())
    per_pass = {k: {f: r[f] for f in ("tracks", "wall_s", "decode_s", "analyze_s",
                                      "tracks_per_sec")} for k, r in runs.items()}
    phase("battery", f"{len(specs)} tracks + {n_analyses - len(specs)} in the extra passes "
                     f"on {card}: synthesis {synth_wall:.1f} s wall in {workers} processes "
                     f"({synth['synth_s']:.1f} s of rendering, {synth['write_s']:.2f} s of "
                     f"writing); runner walls {wall:.1f} s (decode "
                     f"{sum(r['decode_s'] for r in runs.values()):.2f} s beside it, analysis "
                     f"{sum(r['analyze_s'] for r in runs.values()):.2f} s), "
                     f"{n_analyses / wall:.2f} tracks/s; per pass {per_pass}; codec: "
                     f"{steps.get('codec', 'ran')}; overall {summary['overall']}; minus r5: hits "
                     f"{overall_off}, grid {grid_off}, families off "
                     f"{ {f: d for f, d in off_by.items() if any(d.values())} }; tracks that "
                     f"moved against r5 {moved}; launches {launches}; gates {gates}")
    if not all(gates.values()):
        fail(f"battery gates failed: {gates}; analyzed {analyzed}; families minus r5 {off_by}")
    return time.perf_counter() - t_phase, launches


def mesh_phase(port, card: str, batches: dict, lengths, dev) -> dict:
    """The ``[mesh]`` phase: the scale-out of ``parallel/`` on the card.
    A (2 x 2) mesh of ``cuda:0`` against one of the CPU at the tests' size,
    under the default config and under LOUDNESS (with the allocation
    recorder); at the real size the 1-D mesh of 2 and the 2-D (1 x 2) mesh
    (from host memory) against the unsharded run on the same padded batch
    (the key outputs of the 2-D mesh apart: its key STFT is the direct DFT,
    as the JAX package's time blocks compute it); the two-process run.
    Returns the launches of each mesh run, the walls and the peak memory.
    ``dev`` is ``cuda:0`` (the CPU only to rehearse the
    phase's code on small batches)."""
    import torch
    from stratum_dsp_tpu_torch import testing
    from stratum_dsp_tpu_torch.features.key.pipeline import (_key_halo, _key_stft_params,
                                                             detect_key_batch)
    from stratum_dsp_tpu_torch.measure import B_REAL, SECONDS_REAL
    from stratum_dsp_tpu_torch.parallel import mesh as pmesh
    from stratum_dsp_tpu_torch.parallel import timeblocks
    from stratum_dsp_tpu_torch.parallel.multihost import free_port

    t_phase = time.perf_counter()
    cuda0, cpu = dev, torch.device("cpu")
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def check(ref, got, what, skip=(), **kw):
        try:
            return testing.assert_outputs_match({k: v for k, v in ref.items() if k not in skip},
                                                {k: v for k, v in got.items() if k not in skip},
                                                **kw)
        except AssertionError as exc:
            fail(f"[mesh] {what}: {exc}")

    # the tests' size: tests/test_timeblocks.py's four kicks, its capacities
    caps_t = port.PipelineCaps(max_onsets=256, max_beats=256, seg_beat_cap=16, max_segments=6)
    kicks = [torch.as_tensor(testing.kick_pattern(bpm, secs))
             for bpm, secs in ((74.0, 6.0), (132.0, 6.0), (101.0, 5.0), (156.0, 6.0))]
    small, small_n = testing.pad_batch(kicks)
    m_gpu, m_cpu = pmesh.make_mesh([cuda0] * 4, n_time=2), pmesh.make_mesh([cpu] * 4, n_time=2)
    small = pmesh.pad_batch_for_mesh(small, m_gpu)
    out_cpu = pmesh.analyze_batch_sharded(small, small_n, port.AnalysisConfig(),
                                          testing.SAMPLE_RATE, caps_t, m_cpu)
    port.reset_launch_counts()
    out_gpu = pmesh.analyze_batch_sharded(small, small_n, port.AnalysisConfig(),
                                          testing.SAMPLE_RATE, caps_t, m_gpu)
    sync()
    small_launches = {fn.__name__: fn.launches for fn in port.KERNELS}
    if out_gpu["bpm"].device != cuda0 or out_cpu["bpm"].device != cpu:
        fail(f"[mesh] results lie on {out_gpu['bpm'].device} and {out_cpu['bpm'].device}")
    worst = check(out_cpu, out_gpu, "the (2 x 2) mesh differs between the CPU and the card")
    phase("mesh", f"(tracks 2 x time 2) mesh on [cuda:0] * 4 and on [cpu] * 4, 4 kicks of "
                  f"5-6 s: {len(out_gpu)} outputs agree (largest float difference {worst[1]:.3g} "
                  f"in {worst[0]}); escalated {out_gpu['multi_res_triggered'].tolist()}; "
                  f"launches on the card {small_launches}")

    # LOUDNESS on silence sandwiches from a numpy batch, the card's run under
    # the allocation recorder: blocks of ~3 s, and the second track's 3.5 s
    # of leading silence crosses the block edge (its trim shift copies pieces
    # of both blocks); the third is a steady tone, whose BPM confidences are
    # rounding noise (the output contract's noise-floor track)
    def sandwich(lead_s, body, tail_s):
        return torch.cat([torch.zeros(int(lead_s * testing.SAMPLE_RATE)), torch.as_tensor(body),
                          torch.zeros(int(tail_s * testing.SAMPLE_RATE))])

    loud = port.AnalysisConfig(normalization=port.NormalizationMethod.LOUDNESS)
    sw, sw_n = testing.pad_batch([
        sandwich(1.0, testing.kick_pattern(120.0, 3.0), 1.0),
        sandwich(3.5, testing.kick_pattern(96.0, 2.5), 0.5), testing.silence_sandwich(2.0, 2.0),
        sandwich(0.5, testing.kick_pattern(140.0, 4.0), 1.5)])
    sw = pmesh.pad_batch_for_mesh(sw, m_gpu).numpy()
    loud_cpu = pmesh.analyze_batch_sharded(sw, sw_n, loud, testing.SAMPLE_RATE, caps_t, m_cpu)
    rec = testing.AllocationRecorder()
    with rec:
        loud_gpu = pmesh.analyze_batch_sharded(sw, sw_n, loud, testing.SAMPLE_RATE, caps_t, m_gpu)
    sync()
    worst_loud = check(loud_cpu, loud_gpu, "LOUDNESS on the (2 x 2) mesh differs between the CPU "
                       "and the card", noise_floor_track=2)
    key_frame, key_hop = _key_stft_params(loud)
    bound = sw.shape[1] // 2 + key_frame - key_hop + 2 * _key_halo(loud) * key_hop
    trim = loud_gpu["trim_start_seconds"].tolist()
    small_gates = {"no allocation on the card longer than a block and its context":
                   rec.largest[0] <= bound < sw.shape[1],
                   "leading silence across the block edge": trim[1] > sw.shape[1] / 2 / testing.SAMPLE_RATE}
    if not all(small_gates.values()):
        fail(f"[mesh] LOUDNESS on the (2 x 2) mesh: gates failed: {small_gates}; largest "
             f"allocation {rec.largest}, bound {bound}, trim {trim}")
    phase("mesh", f"LOUDNESS, (2 x 2) mesh, 4 silence sandwiches of 6 s from numpy (T "
                  f"{sw.shape[1]}, blocks of {sw.shape[1] // 2}): {len(loud_gpu)} outputs agree "
                  f"between the CPU and the card (largest float difference {worst_loud[1]:.3g} "
                  f"in {worst_loud[0]}); trim starts {[round(v, 4) for v in trim]} s; largest "
                  f"allocation on the card {rec.largest[0]} samples ({rec.largest[1]} "
                  f"{list(rec.largest[2])}), bound {bound}; gates {small_gates}")

    # the real size: the default config, 40 x 180 s, T padded for a time axis
    # of 2; the 2-D mesh takes its batch from host memory, cut into blocks there
    cfg = port.AnalysisConfig()
    meshes = {
        "unsharded": None,
        "1-D": pmesh.make_mesh([torch.device(dev.type, i % n_cards) for i in range(2)]),
        "2-D": pmesh.make_mesh([torch.device(dev.type, i % n_cards) for i in range(2)],
                               n_time=2),
    }
    padded = {k: pmesh.pad_batch_for_mesh(v, meshes["2-D"]) for k, v in batches.items()}
    host = {k: v.cpu() for k, v in padded.items()}
    placed = []  # each 2-D run's blocks: (device, shape, bytes) a mesh position
    from_samples = timeblocks.TimeBlocks.from_samples.__func__

    def record_placement(cls, samples, mesh):
        blocks = from_samples(cls, samples, mesh)
        placed.append([(str(b.device), tuple(b.shape), b.nbytes) for b in blocks.blocks])
        return blocks

    def run(name, mix="adversarial"):
        placed.clear()
        port.reset_launch_counts()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        t0 = time.perf_counter()
        if meshes[name] is None:
            res = port.analyze_batch(padded[mix], lengths, cfg, device=dev)
        elif name == "1-D":
            res = pmesh.analyze_batch_sharded(padded[mix], lengths, cfg, testing.SAMPLE_RATE,
                                              port.PipelineCaps(), meshes[name])
        else:
            timeblocks.TimeBlocks.from_samples = classmethod(record_placement)
            try:
                res = pmesh.analyze_batch_sharded(host[mix], lengths.cpu(), cfg,
                                                  testing.SAMPLE_RATE, port.PipelineCaps(),
                                                  meshes[name])
            finally:
                timeblocks.TimeBlocks.from_samples = classmethod(from_samples)
        sync()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        return res, wall, {fn.__name__: fn.launches for fn in port.KERNELS}, (held, peak)

    outs, walls, launches, memory = {}, {}, {}, {}
    for name in meshes:
        outs[name], wall, launches[name], _ = run(name)
        walls[name] = [wall]
    for name in meshes:  # the first round met the padded shape cold
        res, wall, _, memory[name] = run(name)
        walls[name].append(wall)
    t_pad = padded["adversarial"].shape[1]
    positions = [p for shard in placed for p in shard]
    layout_ok = len(placed) == 1 and [shape for _, shape, _ in positions] == [
        (B_REAL, t_pad // 2)] * 2
    phase("mesh", "the 2-D (1 x 2) mesh's positions, from host memory: " + "; ".join(
        f"(0, {j}) on {d}: [{shape[0]}, {shape[1]}] f32, {nbytes / 1e6:.1f} MB, {shape[1]} "
        f"samples a row of {t_pad}" for j, (d, shape, nbytes) in enumerate(positions)))
    phase("mesh", "peak device memory of the warm batch (torch.cuda.max_memory_allocated, reset "
                  "before it; held before it in brackets): " + ", ".join(
                      f"{k} {v[1] / 1e9:.3f} GB ({v[0] / 1e9:.3f} GB)" for k, v in memory.items())
          + f"; warm walls (s) { {k: round(v[-1], 4) for k, v in walls.items()} } on {card}")
    key_again = {k: res[k] for k in ("key_idx", "key_confidence")}  # the 2-D mesh's
    ref = outs["unsharded"]
    worst_1d = check(ref, outs["1-D"], "the 1-D mesh of 2 differs from the unsharded run")
    key_outputs = ("key_idx", "key_confidence", "key_clarity", "confidence_key_confidence",
                   "confidence_overall_confidence", "warn_low_key_confidence",
                   "warn_low_key_clarity")
    worst_2d = check(ref, outs["2-D"], "the 2-D mesh differs from the unsharded run",
                     skip=key_outputs)
    check({k: outs["2-D"][k] for k in key_again}, key_again,
          "the 2-D mesh's key differs between two runs")
    clean_2d = run("2-D", "clean")[0]
    n_key_moved = int((outs["2-D"]["key_idx"] != ref["key_idx"]).sum())
    # kernel D on the 2-D mesh: every 512-frame chunk of both time blocks, of
    # the base pass and of the escalated rows' hop-256 pass
    want_d = sum(2 * -(-(t_pad // 2 // hop) // 512) for hop in (512, 256))
    gates = {
        "each 2-D position holds its block and no more": layout_ok,
        "scales in C on the 2-D mesh": bool((clean_2d["key_idx"][32:] == 0).all()),
        "escalated on the 2-D mesh": bool(outs["2-D"]["multi_res_used"].any()),
        "A not launched on the 2-D mesh": launches["2-D"]["polyphase_stage2"] == 0,
        "stage 1 not launched on the 2-D mesh": launches["2-D"]["poly_block_dft"] == 0,
        "D in every time block": launches["2-D"]["fused_novelty_features"] == want_d,
        "B and C once a tracks shard": launches["2-D"]["downbeat_mask"] == 1
        and launches["2-D"]["viterbi_decode"] == 1 and launches["1-D"]["downbeat_mask"] == 2,
        "every kernel launched on the 1-D mesh": all(v > 0 for v in launches["1-D"].values()),
    }
    if not all(gates.values()):
        fail(f"[mesh] gates failed: {gates}; launches {launches}; clean keys "
             f"{clean_2d['key_idx'].tolist()}")

    # the 2-D key path's extra time: the key detection alone, in time blocks
    # (the direct DFT) and unsharded (the polyphase form with kernel A)
    time_mesh = meshes["2-D"].row(0)
    x, n = padded["adversarial"], lengths

    def key_ms(mesh):
        detect_key_batch(x, n, cfg, testing.SAMPLE_RATE, mesh=mesh)  # warm-up
        sync()
        t0 = time.perf_counter()
        detect_key_batch(x, n, cfg, testing.SAMPLE_RATE, mesh=mesh)
        sync()
        return 1e3 * (time.perf_counter() - t0)

    key_2d_ms, key_1_ms = key_ms(time_mesh), key_ms(None)
    rate = {k: [round(B_REAL / w, 2) for w in v] for k, v in walls.items()}
    phase("mesh", f"default config, adversarial mix, {B_REAL} x {SECONDS_REAL:.0f} s padded to "
                  f"{x.shape[1]} samples, on {card} ({n_cards} card(s)): the 1-D mesh of 2 equals "
                  f"the unsharded run (largest float difference {worst_1d[1]:.3g} in "
                  f"{worst_1d[0]}); the 2-D (1 x 2) mesh equals it but for the key "
                  f"({worst_2d[1]:.3g} in {worst_2d[0]}), its key the same in two runs, "
                  f"{n_key_moved} of {B_REAL} key indices other than the unsharded "
                  f"polyphase run's; clean mix on the 2-D mesh: scale keys "
                  f"{clean_2d['key_idx'][32:].tolist()}; launches {launches}; walls (s, cold "
                  f"then warm) { {k: [round(w, 4) for w in v] for k, v in walls.items()} }, "
                  f"tracks/s {rate}; key detection alone: time blocks (direct DFT) "
                  f"{key_2d_ms:.1f} ms, unsharded (polyphase) {key_1_ms:.1f} ms, "
                  f"{key_2d_ms - key_1_ms:+.1f} ms; gates {gates}")
    del outs, padded, host, clean_2d

    # two processes, one tracks axis of 8 kicks
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "stratum_dsp_tpu_torch.parallel.multihost",
                           "--device", dev.type, "--port", str(free_port())],
                          capture_output=True, text=True, timeout=600, cwd=REPO)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0 or "multihost smoke: OK" not in log:
        fail(f"[mesh] the two-process run failed ({proc.returncode}): {log[-3000:]}")
    backend = re.findall(r"(?:gloo|nccl) over \S+, \d+ tracks gathered", log)
    phase("mesh", f"two processes x 4 devices (parallel.multihost --device {dev.type}): "
                  f"multihost smoke OK in {time.perf_counter() - t0:.1f} s ({backend})")
    phase("mesh", f"phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches_mesh_1d": launches["1-D"], "launches_mesh_2d": launches["2-D"],
            "walls": walls, "key_2d_extra_ms": key_2d_ms - key_1_ms, "memory": memory}


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this script needs a CUDA card",
              flush=True)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        import stratum_dsp_tpu_torch as port
    except ImportError as exc:
        print(f"FAIL: run from a checkout of the repository ({exc})", flush=True)
        return 1
    from stratum_dsp_tpu_torch import measure, testing
    from stratum_dsp_tpu_torch.measure import B_REAL, SECONDS_REAL, cuda_time_ms
    from stratum_dsp_tpu_torch.features.period.novelty import novelty_tables
    from stratum_dsp_tpu_torch.ops import cuda_build, downbeats, masked, polyphase, viterbi
    from stratum_dsp_tpu_torch.ops import novelty as novelty_ops
    from stratum_dsp_tpu_torch.ops.downbeats import downbeat_mask, downbeat_mask_plain
    from stratum_dsp_tpu_torch.ops.novelty import (fused_novelty_features,
                                                   fused_novelty_features_plain, unpack_features)
    from stratum_dsp_tpu_torch.ops.polyphase import polyphase_stage2, polyphase_stage2_plain
    from stratum_dsp_tpu_torch.ops.viterbi import viterbi_decode, viterbi_decode_plain

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card, flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)} ({card}); torch {torch.__version__}, "
                    f"CUDA {torch.version.cuda}; {torch.cuda.device_count()} card(s)")

    # 2. build
    t0 = time.perf_counter()
    lib_path = cuda_build.build(verbose=True)
    cuda_build.library()
    phase("build", f"{lib_path.name} built or found in {time.perf_counter() - t0:.1f} s")

    # 3. kernel A at the main path's shape: B=40, _auto_chunk -> 192-frame
    # chunks, ext = 192 + 2*12 = 216, EBP = 240, KP = 1024, keep = 931
    (bd, r, ext, keep), (spec, prev2, tables) = measure.kernel_inputs(dev)
    ebp, kp = bd.shape[1], bd.shape[2] // 2
    rng = np.random.default_rng(11)
    got = polyphase_stage2(bd, r, ext, keep)
    torch.cuda.synchronize()
    ref = polyphase_stage2_plain(bd, r, ext, keep)
    # same rounding points and summation order, no FMA contraction: bit-equal
    err_a = float((got.float() - ref.float()).abs().max())
    if not torch.equal(got, ref):
        fail(f"kernel A is not bit-equal to its plain version: max|d| = {err_a}")
    ms_a = cuda_time_ms(lambda: polyphase_stage2(bd, r, ext, keep), 50)
    plain_ms_a = cuda_time_ms(lambda: polyphase_stage2_plain(bd, r, ext, keep), 10)
    bound_a = polyphase.bound_ms(B_REAL, ebp, kp, r, ext, keep)
    phase("kernel A", f"polyphase_stage2 [{B_REAL},{ebp},{2 * kp}] bf16 -> [{B_REAL},{ext},"
                      f"{keep}]: bit-equal to the plain version; "
                      f"kernel {ms_a:.4f} ms, plain {plain_ms_a:.4f} ms, "
                      f"{bound_text(bound_a, ms_a)}")
    # ragged shapes: the fixture batches' chunk (B=4, one long chunk), fewer
    # frames than one tile, bins one past a warp's and a block's edge, one
    # bin (column 0 alone, S[-1] = conj S[1]), spare rows past ext + R - 1
    ragged_a = ((4, 536, 931, 1024, 0), (3, 5, 249, 256, 0), (2, 65, 63, 128, 16),
                (1, 216, 1, 128, 0), (5, 64, 62, 128, 32), (2, 129, 930, 1024, 0))
    for b_, ext_, keep_, kp_, spare in ragged_a:
        bd_ = measure.stage2_input(rng, b_, ext_, kp_, dev, spare)
        ebp_ = bd_.shape[1]
        got = polyphase_stage2(bd_, r, ext_, keep_)
        torch.cuda.synchronize()
        if not torch.equal(got, polyphase_stage2_plain(bd_, r, ext_, keep_)):
            fail(f"kernel A is not bit-equal to its plain version at [{b_},{ebp_},{2 * kp_}], "
                 f"ext {ext_}, keep {keep_}")
    phase("kernel A", f"bit-equal at {len(ragged_a)} ragged shapes "
                      f"(B, ext, keep, KP, spare rows): {ragged_a}")

    # kernel A under enable_key_log_frequency: every bin of the 8192-point
    # STFT is kept, so the chunk is [40, 240, 8448] and keep = 4097
    r_w, ext_w, keep_w, kp_w = measure.STAGE2_WIDE_SHAPE
    bd_w = measure.stage2_input(rng, B_REAL, ext_w, kp_w, dev)
    got = polyphase_stage2(bd_w, r_w, ext_w, keep_w)
    torch.cuda.synchronize()
    ref = polyphase_stage2_plain(bd_w, r_w, ext_w, keep_w)
    err_a = max(err_a, float((got.float() - ref.float()).abs().max()))
    if not torch.equal(got, ref):
        fail("kernel A is not bit-equal to its plain version at the log-frequency shape "
             f"[{B_REAL},{bd_w.shape[1]},{2 * kp_w}], keep {keep_w}")
    del got, ref
    ms_a_wide = cuda_time_ms(lambda: polyphase_stage2(bd_w, r_w, ext_w, keep_w), 20)
    plain_ms_a_wide = cuda_time_ms(lambda: polyphase_stage2_plain(bd_w, r_w, ext_w, keep_w), 3)
    bound_a_wide = polyphase.bound_ms(B_REAL, bd_w.shape[1], kp_w, r_w, ext_w, keep_w)
    ragged_a_wide = ((3, 216, keep_w, kp_w, 0), (7, 100, keep_w, kp_w, 16),
                     (1, 536, keep_w, kp_w, 0))
    for b_, ext_, keep_, kp_, spare in ragged_a_wide:
        bd_ = measure.stage2_input(rng, b_, ext_, kp_, dev, spare)
        got = polyphase_stage2(bd_, r, ext_, keep_)
        torch.cuda.synchronize()
        if not torch.equal(got, polyphase_stage2_plain(bd_, r, ext_, keep_)):
            fail(f"kernel A is not bit-equal to its plain version at [{b_},{bd_.shape[1]},"
                 f"{2 * kp_}], ext {ext_}, keep {keep_}")
    del bd_w, bd_, got
    phase("kernel A, wide", f"polyphase_stage2 [{B_REAL},240,{2 * kp_w}] bf16 -> [{B_REAL},"
                            f"{ext_w},{keep_w}] (log-frequency: every bin kept): bit-equal, also "
                            f"at B = 3, 7, 1 {ragged_a_wide}; kernel {ms_a_wide:.4f} ms, plain "
                            f"{plain_ms_a_wide:.4f} ms, {bound_text(bound_a_wide, ms_a_wide)}")

    # 4. kernel B at the main path's shape: N = max(max_segments*seg_beat_cap,
    # max_beats) = 3072 beat slots with the default capacities. Two sets of
    # beat counts: drawn from 1..N-1 with rows of 0 and N and beats exactly on
    # the +-10% edges (the input of this phase since the kernel was written,
    # so its time stands beside the earlier ones), and the main path's own
    # case, the beats of 180 s tracks at 85-168 BPM
    caps = port.PipelineCaps()
    n = max(caps.max_segments * caps.seg_beat_cap, caps.max_beats)
    walk = measure.walk_inputs(dev)
    times, bar = walk["times"], walk["bar"]
    ms_b, bound_b, plain_ms_b, err_b = {}, {}, None, 0.0
    for case in ("drawn", "main"):
        n_beats = walk[f"n_beats_{case}"]
        got_b = downbeat_mask(times, n_beats, bar)
        torch.cuda.synchronize()
        ref_b = downbeat_mask_plain(times, n_beats, bar)
        err_b = max(err_b, float((got_b.float() - ref_b.float()).abs().max()))
        if not torch.equal(got_b, ref_b):
            fail(f"kernel B ({case}) disagrees with its plain version in "
                 f"{int((got_b != ref_b).sum())} slots")
        ms_b[case] = cuda_time_ms(lambda: downbeat_mask(times, n_beats, bar), 200)
        if case == "drawn":
            plain_ms_b = cuda_time_ms(lambda: downbeat_mask_plain(times, n_beats, bar), 2)
        bound_b[case] = downbeats.bound_ms(B_REAL, n, n_beats.tolist())
        phase("kernel B", f"downbeat_mask [{B_REAL},{n}], beat counts {case} "
                          f"({int(n_beats.min())}..{int(n_beats.max())}): exact "
                          f"({int(got_b.sum())} downbeats); kernel {ms_b[case]:.4f} ms, "
                          f"{bound_text(bound_b[case], ms_b[case])}")
    # the launch alone: an empty kernel of the same grid and shared memory
    empty_b = measure.empty_launch_ms(B_REAL, downbeats.BLOCK_THREADS,
                                      n * downbeats.SMEM_BYTES_PER_SLOT)
    phase("kernel B", f"plain version {plain_ms_b:.4f} ms (drawn); an empty launch of its grid "
                      f"({B_REAL} blocks x {downbeats.BLOCK_THREADS} threads) {empty_b:.4f} ms; "
                      f"the kernel of one thread per track took "
                      f"{EARLIER_MS['downbeat_mask']:.4f} ms (drawn)")

    # 5. kernel C at the main path's shape: B=40, max_beats=1024 beat slots.
    # "em": uniform rows, a row of 1e-3 that underflows through denormals to
    # 0, and rows with a zero tail (this phase's input since the kernel was
    # written: every row dies out within ~100 frames); "em_steady": rows that
    # keep all 1024 frames alive
    ms_c, bound_c, plain_ms_c, err_c = {}, {}, None, 0
    for case, em in measure.decode_inputs(dev).items():
        got_c = viterbi_decode(em)
        torch.cuda.synchronize()
        ref_c = viterbi_decode_plain(em)
        err_c = max(err_c, int((got_c - ref_c).abs().max()))
        if not torch.equal(got_c, ref_c):
            fail(f"kernel C ({case}) disagrees with its plain version in "
                 f"{int((got_c != ref_c).sum())} slots")
        ms_c[case] = cuda_time_ms(lambda: viterbi_decode(em), 200)
        if case == "em":
            plain_ms_c = cuda_time_ms(lambda: viterbi_decode_plain(em), 2)
        frames = viterbi.live_frames(em)
        bound_c[case] = viterbi.bound_ms(B_REAL, caps.max_beats, frames.tolist())
        phase("kernel C", f"viterbi_decode [{B_REAL},{caps.max_beats}], {case} (frames to walk "
                          f"{int(frames.min())}..{int(frames.max())}): exact; kernel "
                          f"{ms_c[case]:.4f} ms, {bound_text(bound_c[case], ms_c[case])}")
    # the backtrack's warp scan on backpointer maps that no emissions produce
    for t_ in (1, 33, caps.max_beats, 3000):
        bp = torch.as_tensor(rng.integers(0, 5, (7, t_, 5)), device=dev)
        last = torch.as_tensor(rng.integers(0, 5, 7), device=dev)
        if not torch.equal(viterbi.backtrack_on_card(bp, last).long(),
                           viterbi.backtrack_plain(bp, last)):
            fail(f"kernel C's backtrack scan disagrees with the plain backtrack at T = {t_}")
    empty_c = measure.empty_launch_ms(B_REAL, viterbi.BLOCK_THREADS,
                                      caps.max_beats * viterbi.SMEM_BYTES_PER_FRAME)
    phase("kernel C", f"plain version {plain_ms_c:.4f} ms (em); backtrack scan exact on random "
                      f"backpointers; an empty launch of its grid ({B_REAL} blocks x "
                      f"{viterbi.BLOCK_THREADS} threads) {empty_c:.4f} ms; the kernel of one warp "
                      f"per track, a lane a state, took {EARLIER_MS['viterbi_decode']:.4f} ms (em)")

    # 5b. B and C past shared memory: their long paths at a batch of whole
    # two-hour mixes (portbench/configs/longmix.json), C at 36,001 beat slots
    # (rows that walk every frame, die out early, end part of the way in, and
    # an empty row), B at 115,200 walk slots (counts of 0 to N, an unsorted
    # row); the plain versions, loops over every slot, timed once by the host
    lw = measure.long_walk_inputs(dev)
    lw_args = (lw["times"], lw["n_beats"], lw["bar"])
    got_b = downbeat_mask(*lw_args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_b = downbeat_mask_plain(*lw_args)
    torch.cuda.synchronize()
    plain_ms_b_long = (time.perf_counter() - t0) * 1e3
    if not torch.equal(got_b, ref_b):
        fail(f"kernel B's long path disagrees with its plain version in "
             f"{int((got_b != ref_b).sum())} slots")
    ms_b_long = cuda_time_ms(lambda: downbeat_mask(*lw_args), 50)
    bound_b_long = downbeats.bound_ms(measure.LONG_ROWS, measure.LONG_SLOTS,
                                      lw["n_beats"].tolist())
    empty_b_long = measure.empty_launch_ms(measure.LONG_ROWS, downbeats.BLOCK_THREADS,
                                           downbeats.LONG_SMEM_BYTES)
    phase("kernel B, long", f"downbeat_mask [{measure.LONG_ROWS},{measure.LONG_SLOTS}] (past "
                            f"shared memory), beat counts {lw['n_beats'].tolist()}: exact "
                            f"({int(got_b.sum())} downbeats); kernel {ms_b_long:.4f} ms, plain "
                            f"{plain_ms_b_long:.1f} ms (host clock, once), "
                            f"{bound_text(bound_b_long, ms_b_long)}; an empty launch of its grid "
                            f"{empty_b_long:.4f} ms")
    em_long = measure.long_decode_inputs(dev)
    got_c = viterbi_decode(em_long)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_c = viterbi_decode_plain(em_long)
    torch.cuda.synchronize()
    plain_ms_c_long = (time.perf_counter() - t0) * 1e3
    if not torch.equal(got_c, ref_c):
        fail(f"kernel C's long path disagrees with its plain version in "
             f"{int((got_c != ref_c).sum())} slots")
    ms_c_long = cuda_time_ms(lambda: viterbi_decode(em_long), 50)
    frames_long = viterbi.live_frames(em_long)
    bound_c_long = viterbi.bound_ms(measure.LONG_ROWS, measure.LONG_FRAMES, frames_long.tolist())
    empty_c_long = measure.empty_launch_ms(measure.LONG_ROWS, viterbi.BLOCK_THREADS,
                                           viterbi.LONG_SMEM_BYTES)
    phase("kernel C, long", f"viterbi_decode [{measure.LONG_ROWS},{measure.LONG_FRAMES}] (past "
                            f"shared memory), frames to walk {frames_long.tolist()}: exact; kernel "
                            f"{ms_c_long:.4f} ms, plain {plain_ms_c_long:.1f} ms (host clock, "
                            f"once), {bound_text(bound_c_long, ms_c_long)}; an empty launch of its "
                            f"grid {empty_c_long:.4f} ms")
    del lw, lw_args, em_long, got_b, ref_b, got_c, ref_c

    # 6. kernel D at the main path's shape: B=40, 256-frame chunks of the
    # 2048-point BPM STFT (with the zeroed frames past a track's end); the
    # base pass's variant and the hop-256 pass's
    err_d, ms_d, plain_ms_d, bound_d = 0.0, {}, {}, {}

    def check_d(spec, prev2, tables, s2, onset, mel, what):
        """Hold kernel D to its plain version: 1e-5 of each output group's
        largest value (the summation order differs; the JAX package's own
        bound), and the same result when launched again (no atomics)."""
        flags = dict(emit_stride2=s2, emit_onset=onset, use_mel=mel)
        got = fused_novelty_features(spec, prev2, tables, **flags)
        torch.cuda.synchronize()
        ref = fused_novelty_features_plain(spec, prev2, tables, **flags)
        unpack = lambda x: unpack_features(x, tables.nb, tables.nm, s2, onset, mel)  # noqa: E731
        groups = {k: (unpack(got)[k], v) for k, v in unpack(ref).items()}
        rel = {k: float((g - r).abs().max() / r.abs().max().clamp_min(1e-12))
               for k, (g, r) in groups.items()}
        used = 4 * tables.nb + tables.nm + 1
        if not max(rel.values()) < 1e-5 or bool(got[..., used:].any()):
            fail(f"kernel D ({what}) is off its plain version: relative errors {rel}")
        if not torch.equal(got, fused_novelty_features(spec, prev2, tables, **flags)):
            fail(f"kernel D ({what}) is not deterministic")
        return float((got - ref).abs().max()), max(rel.values()), flags

    # the wrapper sizes a block's shared memory as the kernel lays it out
    sizes = (tables.mel_packed[1].size, len(tables.edge_windows), len(tables.mel_tasks[0]))
    smem_c = cuda_build.library().stratum_fused_novelty_smem(tables.n_bins, novelty_ops.FRAME_TILE,
                                                             *sizes)
    if smem_c != novelty_ops.kernel_smem_bytes(tables.n_bins, novelty_ops.FRAME_TILE, *sizes):
        fail(f"kernel D: the kernel lays out {smem_c} bytes of shared memory, the wrapper asks "
             f"for {novelty_ops.kernel_smem_bytes(tables.n_bins, novelty_ops.FRAME_TILE, *sizes)}")
    for variant, flags in measure.D_VARIANTS.items():
        err, rel, flags = check_d(spec, prev2, tables, flags["emit_stride2"],
                                  flags["emit_onset"], flags["use_mel"], variant)
        err_d = max(err_d, err)
        ms_d[variant] = cuda_time_ms(lambda: fused_novelty_features(spec, prev2, tables, **flags),
                                     50)
        plain_ms_d[variant] = cuda_time_ms(
            lambda: fused_novelty_features_plain(spec, prev2, tables, **flags), 10)
        bound_d[variant] = novelty_ops.bound_ms(
            B_REAL, 256, tables.n_bins, tables.nb, tables.nm, tables.mel_packed[1].size,
            tables.sf_k, **flags)
        phase("kernel D", f"fused_novelty_features {variant} [{B_REAL},256,{tables.n_bins}] -> "
                          f"[{B_REAL},256,128]: largest relative error per group "
                          f"{rel:.3g}; kernel {ms_d[variant]:.4f} ms, "
                          f"plain {plain_ms_d[variant]:.4f} ms, "
                          f"{bound_text(bound_d[variant], ms_d[variant])}")
    # ragged shapes: the escalation's gathered rows (B=12), one track, frame
    # counts below a tile and no multiple of it, rows of zeros and rows whose
    # maximum is below the onset flux's epsilon; then mel off, bands off, a
    # max-filter radius other than 4, and 2048 bins with sub-bands narrower
    # than the filter
    cfg = port.AnalysisConfig()
    table_sets = {
        "default": tables,
        "mel off": novelty_tables(cfg.replace(enable_tempogram_mel_novelty=False),
                                  testing.SAMPLE_RATE, 2048),
        "full band only": novelty_tables(cfg.replace(enable_tempogram_band_fusion=False),
                                         testing.SAMPLE_RATE, 2048),
        "radius 2": novelty_tables(cfg.replace(tempogram_superflux_max_filter_bins=2),
                                   testing.SAMPLE_RATE, 2048),
        "2048 bins": novelty_ops.NoveltyTables(((0, 2048), (0, 3), (3, 9), (1000, 2048)), 4, None),
    }
    ragged_d = (("default", 12, 256, False, False), ("default", 12, 256, True, True),
                ("default", 1, 5, True, True), ("default", 3, 37, True, True),
                ("default", 2, 37, False, False), ("default", 1, 1, True, True),
                ("mel off", 3, 37, True, True), ("mel off", 40, 256, False, False),
                ("full band only", 2, 40, True, True), ("radius 2", 2, 40, True, True),
                ("2048 bins", 2, 21, True, True))
    for name, b_, c_, s2, onset in ragged_d:
        tab = table_sets[name]
        spec_ = torch.as_tensor(rng.random((b_, c_, tab.n_bins), np.float32) * 3.0, device=dev)
        prev_ = torch.as_tensor(rng.random((b_, 2, tab.n_bins), np.float32), device=dev)
        spec_[0, c_ // 2:] = 0.0
        spec_[-1, c_ // 3] *= 1e-11
        if c_ > 2:
            prev_[-1] *= 1e-11
        check_d(spec_, prev_, tab, s2, onset, tab.mel_w is not None,
                f"{name} [{b_},{c_},{tab.n_bins}] stride2={s2} onset={onset}")
    phase("kernel D", f"within 1e-5 per group and deterministic at {len(ragged_d)} ragged "
                      f"shapes (tables, B, C, stride 2, onset): {ragged_d}")

    # kernel D over a whole track, as the percussive fallback launches it: the
    # auxiliary variant on [40, F, 1025] with a zero carry, one launch. The
    # plain version takes it a slab of frames at a time (its intermediates
    # are several times the 2.5 GB input), the two frames before a slab as
    # its carry
    spec_t, prev_t, _ = measure.whole_track_spectrogram(dev)
    aux = measure.D_VARIANTS["aux"]
    frames_t = spec_t.shape[1]
    n_before = fused_novelty_features.launches
    got_t = fused_novelty_features(spec_t, prev_t, tables, **aux)
    torch.cuda.synchronize()
    if fused_novelty_features.launches != n_before + 1:
        fail("kernel D took more than one launch for a whole track")
    unpack_t = lambda x: unpack_features(x, tables.nb, tables.nm, **aux)  # noqa: E731
    ref_t = torch.empty_like(got_t)
    slab = 1024
    t0 = time.perf_counter()
    for f0 in range(0, frames_t, slab):
        carry = prev_t if f0 == 0 else spec_t[:, f0 - 2:f0]
        ref_t[:, f0:f0 + slab] = fused_novelty_features_plain(spec_t[:, f0:f0 + slab], carry,
                                                              tables, **aux)
    torch.cuda.synchronize()
    plain_ms_d_track = 1e3 * (time.perf_counter() - t0)
    rel_t = {k: float((g - unpack_t(ref_t)[k]).abs().max()
                      / unpack_t(ref_t)[k].abs().max().clamp_min(1e-12))
             for k, g in unpack_t(got_t).items()}
    err_d = max(err_d, float((got_t - ref_t).abs().max()))
    if not max(rel_t.values()) < 1e-5:
        fail(f"kernel D over a whole track is off its plain version: relative errors {rel_t}")
    del got_t, ref_t
    ms_d_track = cuda_time_ms(lambda: fused_novelty_features(spec_t, prev_t, tables, **aux), 5)
    bound_d_track = novelty_ops.bound_ms(B_REAL, frames_t, tables.n_bins, tables.nb, tables.nm,
                                         tables.mel_packed[1].size, tables.sf_k, **aux)
    del spec_t, prev_t
    torch.cuda.empty_cache()
    phase("kernel D, whole track",
          f"fused_novelty_features aux [{B_REAL},{frames_t},{tables.n_bins}] in one launch "
          f"(grid {-(-frames_t // novelty_ops.FRAME_TILE)} x {B_REAL}): largest relative error "
          f"per group {max(rel_t.values()):.3g} against the plain version taken {slab} frames at "
          f"a time; kernel {ms_d_track:.4f} ms, plain {plain_ms_d_track:.1f} ms (host clock, "
          f"{-(-frames_t // slab)} slabs), {bound_text(bound_d_track, ms_d_track)}")

    # the windowed median (no TPU kernel: the JAX package sorts) at the hpss
    # cell's shape, [16, F, 1025] of 180 s tracks, one track's frames cut to
    # a third: both passes of an HPSS iteration at the default margin, bit
    # for bit against the plain version, which sorts the unfolded windows
    # with torch.sort and is the yardstick of its time; then the key path's
    # chroma smoothing [40, 3900, 12] (window 5, element count // 2, ragged
    # frames) and the general path of a half past the register ones
    b_hpss, margin = 16, port.AnalysisConfig().hpss_margin
    spec_m = measure.whole_track_spectrogram(dev)[0][:b_hpss]
    frames_m = spec_m.shape[1]
    counts_m = torch.full((b_hpss,), frames_m, device=dev)
    counts_m[5] = frames_m // 3
    ms_m, plain_ms_m, bound_m = {}, {}, {}
    for axis, dim, nv in (("time", 1, counts_m), ("frequency", 2, None)):
        got_m = masked.window_median(spec_m, nv, margin, True, dim)
        torch.cuda.synchronize()
        if not torch.equal(got_m, masked.window_median_plain(spec_m, nv, margin, True, dim)):
            fail(f"the windowed median ({axis} axis) is not bit-equal to its plain version")
        ms_m[axis] = cuda_time_ms(lambda: masked.window_median(spec_m, nv, margin, True, dim), 20)
        plain_ms_m[axis] = cuda_time_ms(
            lambda: masked.window_median_plain(spec_m, nv, margin, True, dim), 2)
        bound_m[axis] = masked.window_median_bound_ms(
            *masked.window_median_shape(spec_m, dim, margin), margin)
        phase("kernel window_median",
              f"{axis} axis of [{b_hpss},{frames_m},{spec_m.shape[2]}] f32, half {margin}, "
              f"even counts averaged: bit-equal to the plain version; kernel {ms_m[axis]:.4f} ms, "
              f"plain (torch.sort) {plain_ms_m[axis]:.2f} ms, "
              f"{bound_text(bound_m[axis], ms_m[axis])}")
    del spec_m, got_m
    torch.cuda.empty_cache()
    gen_m = torch.Generator(device=dev).manual_seed(14)
    chroma_m = torch.rand((B_REAL, 3900, 12), generator=gen_m, device=dev)
    frames_c = torch.randint(0, 3901, (B_REAL,), generator=gen_m, device=dev)
    frames_c[:4] = torch.tensor([0, 1, 5, 3900], device=dev)
    if not torch.equal(masked.window_median(chroma_m, frames_c, 2, False, 1),
                       masked.window_median_plain(chroma_m, frames_c, 2, False, 1)):
        fail("the windowed median is not bit-equal to its plain version on the chroma")
    ms_chroma = cuda_time_ms(lambda: masked.window_median(chroma_m, frames_c, 2, False, 1), 50)
    wide = masked.MEDIAN_REGISTER_HALF + 8
    ties_m = torch.randint(0, 5, (4, 2000, 1025), generator=gen_m, device=dev).float() * 0.25
    for dim in (1, 2):
        if not torch.equal(masked.window_median(ties_m, None, wide, True, dim),
                           masked.window_median_plain(ties_m, None, wide, True, dim)):
            fail(f"the windowed median's general path (half {wide}) is not bit-equal on ties")
    phase("kernel window_median",
          f"chroma smoothing [{B_REAL},3900,12] half 2, element count // 2, ragged frames: "
          f"bit-equal, kernel {ms_chroma:.4f} ms; general path (half {wide}) bit-equal on ties "
          f"at [4,2000,1025] on both axes")
    del chroma_m, ties_m

    # the HPCP of the bisection peak pick (no TPU kernel: the JAX package
    # leaves it to XLA) at a default key chunk's [40, 183, 931] f32 and a
    # single request's [1, 512, 931]: random magnitudes (~310 peaks a frame),
    # rows of four values (ties at the K-th peak), rows with fewer peaks than
    # K, zero rows, bf16 rows, whitened rows, per-track matrices and the bass
    # band, each within 1e-6 of the plain version (only the order of the 12
    # sums differs); then its launches a key STFT chunk in three configs
    from stratum_dsp_tpu_torch.features.chroma import extractor as chx
    from stratum_dsp_tpu_torch.features.key import pipeline as key_pipeline
    from stratum_dsp_tpu_torch.ops import hpcp

    cfg_k = port.AnalysisConfig()
    sr, fft = testing.SAMPLE_RATE, cfg_k.key_stft_frame_size
    h_args = (cfg_k.soft_mapping_sigma, 0.0, cfg_k.key_hpcp_num_harmonics,
              cfg_k.key_hpcp_harmonic_decay)
    gen_h = torch.Generator(device=dev).manual_seed(16)

    def hpcp_case(shape, fmin=100.0, fmax=5000.0, k_top=24, dtype=torch.float32,
                  whiten=False, per_track=False, ties=False):
        n = shape[-1]
        spec_h = torch.rand(shape, generator=gen_h, device=dev) * 3.0
        if ties:
            spec_h = torch.randint(0, 4, shape, generator=gen_h, device=dev).float()
        spec_h[0, :3] = 0.0  # rows with no peak
        spec_h[-1, -3:] = 1.0  # rows with fewer peaks than K
        spec_h[-1, -3:, 100::100] = 2.0
        spec_h = spec_h.to(dtype)
        sel_h = chx.spectral_whiten(spec_h, 31) if whiten else spec_h
        hi_bin = min(int(np.ceil(fmax / (sr / fft))) + 2, n)
        if per_track:
            tun = torch.rand((shape[0],), generator=gen_h, device=dev) - 0.5
            mat = chx.hpcp_harmonic_matrix_dynamic(sr, fft, hi_bin, h_args[0], tun, *h_args[2:],
                                                   fmin, fmax)
        else:
            mat = chx.hpcp_harmonic_matrix_on(dev, sr, fft, hi_bin, *h_args, fmin, fmax)
        band = hpcp.peak_band(n, hi_bin, sr, fft, fmin, fmax)
        args = (spec_h[..., :hi_bin], sel_h[..., :hi_bin], band, k_top, 0.5, mat)
        got_h = hpcp.hpcp_bisect(*args)
        torch.cuda.synchronize()
        return float((got_h - hpcp.hpcp_bisect_plain(*args)).abs().max()), args

    main_h = ((B_REAL, 183, 931), (1, 512, 931))
    err_h, ms_h, plain_ms_h, bound_h = 0.0, {}, {}, {}
    for shape in main_h:
        err, args = hpcp_case(shape)
        err_h = max(err_h, err)
        ms_h[shape] = cuda_time_ms(lambda a=args: hpcp.hpcp_bisect(*a), 50)
        plain_ms_h[shape] = cuda_time_ms(lambda a=args: hpcp.hpcp_bisect_plain(*a), 10)
        bound_h[shape] = hpcp.hpcp_bisect_bound_ms(shape[0] * shape[1], shape[2], 24)
        phase("kernel hpcp_bisect",
              f"{list(shape)} f32, 24 peaks, 4 harmonics: {err:.3g} from the plain version; "
              f"kernel {ms_h[shape]:.4f} ms, plain {plain_ms_h[shape]:.4f} ms, "
              f"{bound_text(bound_h[shape], ms_h[shape])}")
    cases_h = {"ties": dict(ties=True), "bf16": dict(dtype=torch.bfloat16),
               "bf16 ties": dict(dtype=torch.bfloat16, ties=True),
               "whitened": dict(whiten=True), "whitened bf16": dict(whiten=True,
                                                                    dtype=torch.bfloat16),
               "per-track": dict(per_track=True),
               "bass band": dict(fmin=55.0, fmax=300.0, k_top=12),
               "wide band": dict(fmax=20000.0)}
    errs_h = {}
    for name, kw in cases_h.items():
        shape = (8, 64, 4097) if name == "wide band" else (B_REAL, 183, 931)
        errs_h[name] = hpcp_case(shape, **kw)[0]
    err_h = max(err_h, *errs_h.values())
    if err_h > 1e-6:
        fail(f"hpcp_bisect differs from its plain version by {err_h:.3g}: "
             f"{errs_h} (main shapes included in the first)")
    n_chunks_h, launched_h = {}, {}
    x_h = testing.c_major_scale().repeat(2)[None].repeat(2, 1)
    n_h = torch.full((2,), x_h.shape[1], dtype=torch.int64)
    for name, overrides in (("default", {}), ("bass blend", dict(enable_key_hpcp_bass_blend=True)),
                            ("tuned-exact", dict(key_hpcp_approx_peaks=False))):
        port.reset_launch_counts()
        key_pipeline.extract_key_features(x_h.to(dev), n_h.to(dev), cfg_k.replace(**overrides),
                                          sr, chunk_frames=128)
        torch.cuda.synchronize()
        n_chunks_h[name] = port.tracing.counters()["key_stft_chunks"]
        launched_h[name] = hpcp.hpcp_bisect.launches
        if port.tracing.counters().get("hpcp_kernel", 0) != launched_h[name]:
            fail(f"hpcp_kernel counts {port.tracing.counters()} against {launched_h[name]} "
                 "launches")
    if launched_h != {"default": n_chunks_h["default"], "bass blend": 2 * n_chunks_h["bass blend"],
                      "tuned-exact": 0}:
        fail(f"hpcp_bisect launches {launched_h} for key STFT chunks {n_chunks_h}")
    phase("kernel hpcp_bisect",
          f"within 1e-6 of the plain version on {', '.join(cases_h)} ({errs_h}); launches "
          f"{launched_h} over key STFT chunks {n_chunks_h}")

    # the direct windowed DFT's magnitudes (ops/stft.py:stft_magnitude; the
    # JAX package leaves the product to XLA) at the base BPM chunk and the
    # escalation's, each against the plain version and an f64 DFT of the same
    # bf16-rounded operands; then masked and ragged chunks and the 2-D mesh's
    # key shape
    from stratum_dsp_tpu_torch.ops import stft as stft_ops
    from stratum_dsp_tpu_torch.ops import tables as stft_tables

    gen_s = torch.Generator(device=dev).manual_seed(18)

    def stft_case(b, n, hop, keep, frames, frame0=0, counts=None):
        basis = stft_tables.on(dev, stft_ops.hann_basis, n, keep, True)
        x_s = torch.randn((b, (frames - 1) * hop + n), generator=gen_s, device=dev) * 0.3
        fc = torch.full((b,), frame0 + frames + 1, dtype=torch.int64, device=dev) \
            if counts is None else counts
        args = (x_s, frames, hop, basis, frame0, fc)
        got_s = stft_ops.stft_magnitude(*args)
        plain_s = stft_ops.stft_magnitude_plain(*args)
        fr = stft_ops.extract_frames(x_s, frames, n, hop).to(torch.bfloat16).double()
        ri = fr @ basis.double()
        k = basis.shape[1] // 2
        exact = torch.sqrt(ri[..., :k] ** 2 + ri[..., k:] ** 2)
        fidx = frame0 + torch.arange(frames, device=dev)
        exact = torch.where(((fidx >= 0)[None] & (fidx[None] < fc[:, None]))[..., None], exact,
                            0.0)
        err_k = (got_s.double() - exact).abs().amax(dim=-1)
        err_p = (plain_s.double() - exact).abs().amax(dim=-1)
        slack = err_k - 4 * err_p - 1e-6 * fr.norm(dim=-1) * stft_ops.hann_window(n, dev).norm()
        torch.cuda.synchronize()
        return float(slack.max()), float((got_s - plain_s).abs().max()), args

    main_s = {"base": (B_REAL, 2048, 512, None, 256), "escalation": (12, 2048, 256, None, 256)}
    ms_s, plain_ms_s, bound_s, err_s = {}, {}, {}, 0.0
    for name, (b, n, hop, keep, frames) in main_s.items():
        slack, diff, args = stft_case(b, n, hop, keep, frames)
        if slack > 0:
            fail(f"stft_magnitude {name}: off the f64 DFT by more than its bound ({slack:.3g})")
        err_s = max(err_s, diff)
        ms_s[name] = cuda_time_ms(lambda a=args: stft_ops.stft_magnitude(*a), 50)
        plain_ms_s[name] = cuda_time_ms(lambda a=args: stft_ops.stft_magnitude_plain(*a), 10)
        bound_s[name] = stft_ops.stft_magnitude_bound_ms(b, frames, n, hop, 1025)
        phase("kernel stft_magnitude",
              f"{name} [{b}, {frames}, {n}] hop {hop}: {diff:.3g} from the plain version; kernel "
              f"{ms_s[name]:.4f} ms, plain {plain_ms_s[name]:.4f} ms, "
              f"{bound_text(bound_s[name], ms_s[name])}")
    ragged = torch.tensor([5, 300, 40, 0, 260, 1, 255, 128, 77, 3, 200, 259], device=dev)
    cases_s = {"halo, ragged rows": dict(b=12, n=2048, hop=256, keep=None, frames=260, frame0=-2,
                                        counts=ragged),
               "past every row's end": dict(b=16, n=2048, hop=512, keep=None, frames=256,
                                            frame0=15000, counts=torch.full(
                                                (16,), 14000, dtype=torch.int64, device=dev)),
               "2-D mesh key": dict(b=B_REAL, n=8192, hop=512, keep=931, frames=24, frame0=-4)}
    for name, kw in cases_s.items():
        slack, diff, _ = stft_case(**kw)
        if slack > 0:
            fail(f"stft_magnitude {name}: off the f64 DFT by more than its bound ({slack:.3g})")
        err_s = max(err_s, diff)
    phase("kernel stft_magnitude",
          f"within its bound of the f64 DFT on {', '.join(cases_s)}; "
          f"largest difference from the plain version {err_s:.3g}")

    # stage 1 of the polyphase key STFT (ops/stft.py:poly_block_dft; the JAX
    # package leaves the product to XLA) at a default key chunk and at the
    # log-frequency width, each against the plain version: every element
    # within one bf16 ulp of the plain one or, near zero, where another sum
    # order moves more bits, within 1e-6 of its block's norm times its
    # column's; then the hpss cell's and a single request's chunks and a later
    # chunk of unaligned rows
    gen_p = torch.Generator(device=dev).manual_seed(20)

    def poly_case(b, ebp, kp, start=0, offset=0):
        x_p = torch.randn((b, (start + ebp + 1) * 512 + offset), generator=gen_p,
                          device=dev)[:, offset:] * 0.3
        args = (x_p, start, ebp, 8192, 512, kp)
        got_p = stft_ops.poly_block_dft(*args).float()
        plain_p = stft_ops.poly_block_dft_plain(*args).float()
        blocks = x_p[:, start * 512:(start + ebp) * 512].reshape(b, ebp, 512)
        cols = stft_tables.on(dev, stft_ops._poly_block_basis, 8192, 512, kp, True).float()
        d = (got_p - plain_p).abs()
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.maximum(got_p.abs(), plain_p.abs()).clamp_min(1e-30))) - 7)
        scale = blocks.to(torch.bfloat16).float().norm(dim=-1, keepdim=True) * cols.norm(dim=0)
        stats = {"differ": int((d > 0).sum()), "beyond_one_ulp": int((d > ulp).sum()),
                 "out_of_bound": int(((d > ulp) & (d > 1e-6 * scale)).sum()),
                 "elements": d.numel(), "max_abs": float(d.max())}
        torch.cuda.synchronize()
        return stats, args

    main_p = {"default": (B_REAL, 240, 1024), "wide": (B_REAL, 240, 4224)}
    ms_p, plain_ms_p, bound_p, stats_p = {}, {}, {}, {}
    for name, (b, ebp, kp) in main_p.items():
        stats_p[name], args = poly_case(b, ebp, kp)
        ms_p[name] = cuda_time_ms(lambda a=args: stft_ops.poly_block_dft(*a), 50)
        plain_ms_p[name] = cuda_time_ms(lambda a=args: stft_ops.poly_block_dft_plain(*a), 10)
        bound_p[name] = stft_ops.poly_block_dft_bound_ms(b, ebp, 512, kp)
        phase("kernel poly_block_dft",
              f"{name} [{b}, {ebp}, 512] -> [{b}, {ebp}, {2 * kp}] bf16: {stats_p[name]} "
              f"against the plain version; kernel {ms_p[name]:.4f} ms, plain "
              f"{plain_ms_p[name]:.4f} ms, {bound_text(bound_p[name], ms_p[name])}")
    cases_p = {"hpss": (16, 512, 1024), "single": (1, 560, 1024),
               "later chunk, unaligned rows": (3, 240, 1024, 48, 1)}
    for name, case in cases_p.items():
        stats_p[name] = poly_case(*case)[0]
    if any(v["out_of_bound"] for v in stats_p.values()):
        fail(f"poly_block_dft is off its plain version beyond one ulp and 1e-6 of the norms: "
             f"{stats_p}")
    err_p = max(v["max_abs"] for v in stats_p.values())
    phase("kernel poly_block_dft",
          f"within one ulp or 1e-6 of the norms of the plain version on {', '.join(cases_p)}: "
          f"{ {k: stats_p[k] for k in cases_p} }")

    # 7. fixture batches, CPU (plain versions) vs card (kernels): the slice
    # batch under SLICE_CONFIG, and under the default config a batch that
    # takes every branch of the escalation
    fixture = [testing.kick_patterns([120.0], 8.0)[0], testing.kick_patterns([128.0], 7.5)[0],
               testing.c_major_scale(), testing.silence_sandwich(5.0, 5.0)]
    samples, lengths = testing.pad_batch(fixture)
    out_cpu = port.analyze_batch(samples, lengths, port.SLICE_CONFIG, device="cpu")
    out_gpu = port.analyze_batch(samples, lengths, port.SLICE_CONFIG)  # no device: the card
    torch.cuda.synchronize()
    # the silence sandwich (track 3) is a steady tone: its tempogram
    # confidences ride on the BPM STFT matmul's accumulation order (cuBLAS
    # here, MKL or oneDNN on the CPU) and are held to the noise-floor bound
    if out_cpu["bpm"].device.type != "cpu" or out_gpu["bpm"].device.type != "cuda":
        fail(f"analyze_batch ran on {out_gpu['bpm'].device} without a device argument and on "
             f"{out_cpu['bpm'].device} when asked for the CPU")
    worst = testing.assert_outputs_match(out_cpu, out_gpu, noise_floor_track=3)
    phase("slice cpu/gpu", f"{len(out_cpu)} outputs agree on the fixture batch "
                           f"(largest float difference {worst[1]:.3g} in {worst[0]})")
    samples = testing.kick_patterns([75.0, 120.0, 128.0, 172.0], 8.0)
    lengths = torch.full((4,), samples.shape[1], dtype=torch.int64)
    out_cpu = port.analyze_batch(samples, lengths, device="cpu")
    out_gpu = port.analyze_batch(samples.numpy(), lengths.numpy())  # host arrays in
    torch.cuda.synchronize()
    worst = testing.assert_outputs_match(out_cpu, out_gpu)
    trig, used = out_gpu["multi_res_triggered"].cpu(), out_gpu["multi_res_used"].cpu()
    if not (used.any() and (trig & ~used).any() and not trig.all()):
        fail(f"the escalation fixture no longer takes every branch: triggered {trig.tolist()}, "
             f"used {used.tolist()}")
    phase("multi-res cpu/gpu", f"{len(out_cpu)} outputs agree on kicks at 75/120/128/172 BPM "
                               f"(triggered {trig.tolist()}, used {used.tolist()}; largest "
                               f"float difference {worst[1]:.3g} in {worst[0]})")

    # 8-10. real size: 40 tracks x 180 s made on the card
    n_samples = int(SECONDS_REAL * testing.SAMPLE_RATE)
    batches, lengths = measure.real_size_mixes(dev)

    def run(batch, cfg):
        """One batch with every launch count set to 0 before and read after."""
        port.reset_launch_counts()
        t0 = time.perf_counter()
        res = port.analyze_batch(batch, lengths, cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return res, wall, {fn.__name__: fn.launches for fn in port.KERNELS}

    def n_chunks(hop):  # BPM STFT chunks of 256 frames in one track
        return -(-((n_samples - 2048) // hop + 1) // 256)

    def want_launches(escalated: bool, cfg_multires: bool = True, key_passes: int = 1,
                      whole_track_d: int = 0, medians: int = 1, hpcp: int = 81):
        """Launches of one batch: the key STFT's 81 chunks a pass (tuning
        compensation and the HPSS harmonic mask each add a pass), one downbeat
        walk, one decode, a reducer launch per BPM chunk (and per hop-256
        chunk when a track escalates), one over the whole percussive
        spectrogram where the percussive fallback is on, a windowed median
        for the chroma smoothing (and two an HPSS iteration), and an HPCP a
        chunk of the extraction pass where the bisection picks the peaks; a
        direct DFT a BPM chunk and hop-256 chunk, and a chunk of the HPSS
        spectrogram where the percussive fallback is on."""
        esc = n_chunks(256) if escalated and cfg_multires else 0
        d = n_chunks(512) + esc + whole_track_d
        return {"polyphase_stage2": 81 * key_passes, "downbeat_mask": 1, "viterbi_decode": 1,
                "fused_novelty_features": d, "window_median": medians, "hpcp_bisect": hpcp,
                "stft_magnitude": n_chunks(512) * (2 if whole_track_d else 1) + esc,
                "poly_block_dft": 81 * key_passes}

    def gates_for(res, seeds, core, launches, **changes):
        res = {k: v.cpu().numpy() for k, v in res.items()}
        n = len(seeds)
        bpm = res["bpm"][:n]
        err = np.abs(bpm - seeds)
        fam = np.minimum.reduce([err, np.abs(bpm - 2 * seeds), np.abs(bpm - 0.5 * seeds)])
        gates = {
            "all ok": bool(res["ok"].all()),
            "core kicks exact": bool((err[core] <= 2.0).all()),
            "trap kicks family-exact": bool((fam[~core] <= 2.0).all()),
            "scales in C": bool((res["key_idx"][n:] == 0).all()),
            "beats on every track": bool(res["beat_valid"].any(axis=1).all()),
            "downbeats on every track": bool(res["downbeat_valid"].any(axis=1).all()),
            "launches": launches == want_launches(bool(res["multi_res_triggered"].any()),
                                                  **changes),
        }
        return gates, res, bpm

    # 8. the slice's path (SLICE_CONFIG, multi-resolution off), one counted batch
    seeds, clean = measure.CLEAN_BPMS, batches["clean"]
    run(clean, port.SLICE_CONFIG)  # warm-up
    out, wall, launches = run(clean, port.SLICE_CONFIG)
    bpm = out["bpm"][:32].cpu().numpy()
    fam = np.minimum.reduce([np.abs(bpm - seeds), np.abs(bpm - 2 * seeds),
                             np.abs(bpm - 0.5 * seeds)])
    gates = {"all ok": bool(out["ok"].all()), "kick BPM family-exact": bool((fam <= 2.0).all()),
             "no escalation": not bool(out["multi_res_used"].any()),
             "launches": launches == want_launches(False, cfg_multires=False)}
    phase("slice real size", f"SLICE_CONFIG, 32 kicks + 8 scales: one batch in {wall:.4f} s "
                             f"({B_REAL / wall:.2f} tracks/s); launches {launches}; "
                             f"gates {gates}")
    if not all(gates.values()):
        fail(f"slice real-size gates failed: {gates}")

    # 9-10. the default config on both mixes: a warm-up, then three timed
    # batches; the first is the one whose launches are counted and gated
    mixes = (("clean", seeds, clean, np.ones(32, bool)),
             ("adversarial", measure.ADVERSARIAL_BPMS, batches["adversarial"],
              np.arange(40) < 28))
    main_launches, rates_by_mix = None, {}
    for name, mix_seeds, batch, core in mixes:
        run(batch, port.AnalysisConfig())  # warm-up
        out, wall, launches = run(batch, port.AnalysisConfig())
        walls = [wall] + [run(batch, port.AnalysisConfig())[1] for _ in range(TIMED_BATCHES - 1)]
        rates = sorted(B_REAL / w for w in walls)
        rates_by_mix[name] = float(np.median(rates))
        gates, res, bpm = gates_for(out, mix_seeds, core, launches)
        n_trig, n_used = int(res["multi_res_triggered"].sum()), int(res["multi_res_used"].sum())
        gates["stage 1 one launch a key chunk, 81"] = launches["poly_block_dft"] == 81
        if name == "adversarial":
            gates["multi-res triggered and used"] = n_trig > 0 and n_used > 0
            main_launches = launches
        phase(f"default real size, {name}",
              f"{B_REAL} x {SECONDS_REAL:.0f} s, {TIMED_BATCHES} timed batches: walls "
              f"{[round(w, 4) for w in walls]} s; median {rates_by_mix[name]:.2f} tracks/s "
              f"(min {rates[0]:.2f}, max {rates[-1]:.2f}) on {card}; escalated: triggered "
              f"{n_trig}, used {n_used}; launches in the first {launches}; gates {gates}")
        if not all(gates.values()):
            fail(f"{name} real-size gates failed: {gates}; bpm {bpm.tolist()}; "
                 f"keys {res['key_idx'].tolist()}")

    # where the time goes on the adversarial mix: the pipeline stopped at
    # each stage boundary (a warm-up and two timed runs per prefix, median)
    adversarial = batches["adversarial"]
    stages = port.stage_timings(adversarial, lengths, reps=2, device=dev)
    phase("stages, adversarial", "cumulative ms (and since the boundary before): " + "; ".join(
        f"{k} {1e3 * stages[k]:.1f} ({1e3 * stages[k + '_delta']:+.1f})"
        for k in stages if not k.endswith("_delta")))

    # the opt-in configs at the real size, on the adversarial mix: a warm-up
    # and timed batches, the default gates, the launch counts the config
    # implies, peak device memory and stage times; the HPSS config the times
    # of its own three stages instead of the six prefixes
    opt_in = {}
    core = np.arange(40) < 28
    for name, spec_cfg in measure.OPT_IN_CONFIGS.items():
        cfg_o = measure.opt_in_config(name)
        run_o = measure.timed_batches(adversarial, lengths, cfg_o, dev, 2)
        counts_o = port.tracing.counters()  # the last timed batch's
        gates, res, bpm = gates_for(run_o["out"], measure.ADVERSARIAL_BPMS, core,
                                    run_o["launches"], key_passes=spec_cfg["key_passes"],
                                    whole_track_d=spec_cfg["whole_track_d"],
                                    medians=spec_cfg["medians"], hpcp=spec_cfg["hpcp"])
        if name == "log-frequency":
            # every bin of the 8192-point key STFT kept, in each of A's 81 chunks
            gates["key STFT bins a pass 4097"] = counts_o.get("key_stft_bins", 0) == (
                measure.STAGE2_WIDE_SHAPE[2] * counts_o.get("key_stft_passes", -1))
            gates["kernel A 81 launches"] = run_o["launches"]["polyphase_stage2"] == 81
        if name == "hpss":
            gates["percussive fallback triggered"] = bool(res["percussive_triggered"].any())
            stages_o = measure.hpss_stage_times(adversarial, lengths, cfg_o, dev)
            stage_text = "; ".join(f"{k[:-2]} {1e3 * v:.1f}" for k, v in stages_o.items())
        else:
            stages_o = port.stage_timings(adversarial, lengths, cfg_o, reps=1, device=dev)
            stage_text = "; ".join(
                f"{k} {1e3 * stages_o[k]:.1f} ({1e3 * stages_o[k + '_delta']:+.1f})"
                for k in stages_o if not k.endswith("_delta"))
        rate = B_REAL / float(np.median(run_o["walls_s"]))
        opt_in[name] = {"tracks_per_s": rate, "peak_memory_gb": run_o["peak_memory_gb"],
                        "launches": run_o["launches"]}
        phase(f"opt-in real size, {name}",
              f"{spec_cfg['overrides']}: {B_REAL} x {SECONDS_REAL:.0f} s, adversarial mix, walls "
              f"{[round(w, 4) for w in run_o['walls_s']]} s; {rate:.2f} tracks/s on {card}; peak "
              f"device memory {run_o['peak_memory_gb']:.2f} GB; launches {run_o['launches']}; "
              f"key STFT passes {counts_o.get('key_stft_passes')}, bins "
              f"{counts_o.get('key_stft_bins')}; "
              f"percussive triggered {int(res['percussive_triggered'].sum())}, used "
              f"{int(res['percussive_used'].sum())}; stage ms: {stage_text}; gates {gates}")
        if not all(gates.values()):
            fail(f"opt-in '{name}' real-size gates failed: {gates}; bpm {bpm.tolist()}; "
                 f"keys {res['key_idx'].tolist()}")
        del run_o, res
        torch.cuda.empty_cache()

    # the opt-in paths, CPU against card, on kicks at 75 / 120 / 172 BPM and
    # the C-major scale (8 s each): configs that together switch on every
    # branch the default config leaves off. The escalation is off except where
    # the config is about it. (After the timed batches: the CPU side's HPSS
    # keeps the host's cores busy for a while)
    kicks = testing.kick_patterns([75.0, 120.0, 172.0], 8.0)
    samples_v, lengths_v = testing.pad_batch([*kicks, testing.c_major_scale().repeat(2)])
    variants = {
        "hpss onsets + percussive fallback + fusion + LOUDNESS": dict(
            enable_hpss_onsets=True, enable_tempogram_percussive_fallback=True,
            enable_bpm_fusion=True, normalization=port.NormalizationMethod.LOUDNESS),
        "forced legacy + RMS": dict(force_legacy_bpm=True,
                                    normalization=port.NormalizationMethod.RMS),
        "fractional beat contrast": dict(beat_contrast_fractional=True,
                                         enable_tempogram_multi_resolution=True),
        "log-frequency": dict(enable_key_log_frequency=True, enable_key_hpcp=False),
        "tuning + bass blend + whitening + exact peaks": dict(
            enable_key_tuning_compensation=True, enable_key_hpcp_bass_blend=True,
            enable_key_hpcp_whitening=True, key_hpcp_approx_peaks=False),
        "tuning + bass blend + whitening, bisection peaks": dict(
            enable_key_tuning_compensation=True, enable_key_hpcp_bass_blend=True,
            enable_key_hpcp_whitening=True),
        # without conditioning the HPCP takes the key STFT's bf16 rows (whitened
        # bf16 rows are left out: the whitening's bf16 running sums differ
        # between the CPU and the card by 0.02 in key clarity, plain or kernel)
        "tuning + bass blend, bisection peaks on bf16 rows": dict(
            enable_key_tuning_compensation=True, enable_key_hpcp_bass_blend=True,
            enable_key_harmonic_mask=False, enable_key_spectrogram_time_smoothing=False),
        "hpss harmonic mask": dict(enable_key_hpss_harmonic=True, enable_key_harmonic_mask=False),
        "ensemble": dict(enable_key_ensemble=True),
        "median": dict(enable_key_median=True, enable_key_segment_voting=False,
                       key_median_segment_length_frames=120, key_median_segment_hop_frames=30),
        "multi-scale + mode heuristic + edge trim": dict(
            enable_key_multi_scale=True, key_multi_scale_lengths=(60, 120),
            enable_key_mode_heuristic=True, enable_key_edge_trim=True),
        "beat-synchronous + plain chroma + key STFT 2048": dict(
            enable_key_beat_synchronous=True, enable_key_stft_override=False),
    }
    agreed = []
    for name, overrides in variants.items():
        cfg_v = port.SLICE_CONFIG.replace(**overrides)
        out_cpu = port.analyze_batch(samples_v, lengths_v, cfg_v, device="cpu")
        port.reset_launch_counts()
        out_gpu = port.analyze_batch(samples_v, lengths_v, cfg_v)
        torch.cuda.synchronize()
        try:
            worst = testing.assert_outputs_match(out_cpu, out_gpu)
        except AssertionError as exc:
            fail(f"variant '{name}' differs between the CPU and the card: {exc}")
        if not bool(out_gpu["ok"].all()) or fused_novelty_features.launches == 0:
            fail(f"variant '{name}': ok {out_gpu['ok'].tolist()}, kernel D launched "
                 f"{fused_novelty_features.launches} times")
        if "percussive" in name and not bool(out_gpu["percussive_triggered"].any()):
            fail("the percussive fallback was triggered on no fixture track")
        if "legacy" in name and not bool(out_gpu["legacy_used"][:3].all()):
            fail(f"forced legacy: legacy_used {out_gpu['legacy_used'].tolist()}")
        agreed.append(f"{name} ({worst[1]:.2g} in {worst[0]})")
    phase("variants cpu/gpu", f"{len(out_cpu)} outputs agree on kicks at 75/120/172 BPM and the "
                              f"C-major scale under {len(variants)} opt-in configs (largest float "
                              f"difference): " + "; ".join(agreed))

    # 11. the file path: the adversarial mix as 16-bit WAVs, through both CLIs
    # on the card. The reference is the same samples (the 16-bit values, so
    # both sides read equal numbers) analyzed in memory at the shape the CLI
    # gives them: the batch CLI pads a 180 s track to its 240 s bucket, and a
    # result depends on the padded length in both packages (the tempogram's
    # FFT size follows it), while analyze_file analyzes a track at its own
    # length. Same shapes, same samples: BPM within BPM_TOL, key, counts and
    # methods exactly
    from stratum_dsp_tpu_torch.cli import analyze_batch as batch_cli
    from stratum_dsp_tpu_torch.cli import analyze_file as file_cli
    from stratum_dsp_tpu_torch.io import decode as audio

    seeds_adv = measure.ADVERSARIAL_BPMS
    with tempfile.TemporaryDirectory(prefix="stratum_smoke_") as tmp:
        t0 = time.perf_counter()
        paths, quantized = measure.write_wavs(adversarial, tmp)
        write_s = time.perf_counter() - t0
        bucket = batch_cli.bucket_for(n_samples, testing.SAMPLE_RATE)
        in_memory = port.decode_results(port.analyze_batch_timed(
            torch.nn.functional.pad(quantized, (0, bucket - n_samples)), lengths,
            sample_rate=testing.SAMPLE_RATE, device=dev), testing.SAMPLE_RATE)
        in_memory_one = port.decode_results(port.analyze_batch_timed(
            quantized[30:31], lengths[30:31], sample_rate=testing.SAMPLE_RATE, device=dev),
            testing.SAMPLE_RATE)[0]
        t0 = time.perf_counter()
        decoded = audio.decode_batch(paths, target_sr=testing.SAMPLE_RATE)
        decode_s = time.perf_counter() - t0
        written = quantized[:2].cpu().numpy()
        if any(err is not None for _, _, err in decoded) or not all(
                np.array_equal(x, q) for (x, _, _), q in zip(decoded, written)):
            fail(f"the {audio.decoder_backend()} decoder does not give the samples that were "
                 f"written: {[err for _, _, err in decoded if err]}")
        del decoded
        jsonl = Path(tmp) / "out.jsonl"
        walls_files, file_launches = [], None
        for _ in range(2):  # the first run meets the 240 s bucket's shape cold
            port.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(io.StringIO()) as summary:
                rc = batch_cli.main([*paths, "-o", str(jsonl)])
            torch.cuda.synchronize()
            walls_files.append(time.perf_counter() - t0)
            file_launches = {fn.__name__: fn.launches for fn in port.KERNELS}
            if rc != 0:
                fail(f"cli.analyze_batch exited with {rc}: {summary.getvalue()}")
        records = {r["file"]: r for r in map(json.loads, jsonl.read_text().splitlines())}
        single = io.StringIO()
        with contextlib.redirect_stdout(single):
            rc = file_cli.main([paths[30], "--json"])
        if rc != 0:
            fail(f"cli.analyze_file exited with {rc}")
        single = json.loads(single.getvalue())
        # one opt-in flag through the CLI, against the same track in memory
        ensemble = io.StringIO()
        with contextlib.redirect_stdout(ensemble):
            rc = file_cli.main([paths[30], "--json", "--enable-key-ensemble", "true"])
        if rc != 0:
            fail(f"cli.analyze_file --enable-key-ensemble true exited with {rc}")
        ensemble = json.loads(ensemble.getvalue())
        in_memory_ensemble = port.decode_results(port.analyze_batch_timed(
            quantized[30:31], lengths[30:31],
            port.AnalysisConfig(enable_key_ensemble=True), testing.SAMPLE_RATE, device=dev),
            testing.SAMPLE_RATE)[0]
    if Path(tmp).exists():
        fail(f"the temporary directory {tmp} was not removed")

    def same_result(rec, ref):
        ref = ref.to_dict()
        return (abs(rec["bpm"] - ref["bpm"]) <= testing.BPM_TOL
                and all(rec[k] == ref[k] for k in ("key", "key_numerical", "beat_count",
                                                   "downbeat_count", "methods_used")))

    recs = [records.get(p, {"error": "no record"}) for p in paths]
    analyzed = [r for r in recs if "error" not in r]
    gates = {"every track analyzed": len(analyzed) == len(records) == B_REAL}
    if gates["every track analyzed"]:
        bpm = np.asarray([r["bpm"] for r in recs])
        err = np.abs(bpm - seeds_adv)
        fam = np.minimum.reduce([err, np.abs(bpm - 2 * seeds_adv), np.abs(bpm - 0.5 * seeds_adv)])
        core = np.arange(B_REAL) < 28
        n_trig_mem = sum(bool(r.metadata.tempogram_multi_res_triggered) for r in in_memory)
        gates.update({
            "core kicks exact": bool((err[core] <= 2.0).all()),
            "trap kicks family-exact": bool((fam[~core] <= 2.0).all()),
            "beats on every track": all(r["beat_count"] > 0 for r in recs),
            "downbeats on every track": all(r["downbeat_count"] > 0 for r in recs),
            "escalated as in memory": sum(r["tempogram_multi_res_triggered"] for r in recs)
            == n_trig_mem > 0 and any(r["tempogram_multi_res_used"] for r in recs),
            "same results as in memory": all(same_result(r, m) for r, m in zip(recs, in_memory)),
            "analyze_file as in memory": same_result(single, in_memory_one),
            "analyze_file --enable-key-ensemble as in memory":
                same_result(ensemble, in_memory_ensemble),
            "every kernel launched": all(v > 0 for v in file_launches.values()),
            "schema": all(list(r) == ["file", *port.AnalysisResult().to_dict()] for r in recs)
            and list(single) == list(port.AnalysisResult().to_dict()),
        })
    analyze_s = sum(r.get("processing_time_ms", 0.0) for r in recs) / 1e3
    phase("files", f"{B_REAL} x {SECONDS_REAL:.0f} s 16-bit WAVs (written in {write_s:.2f} s; "
                   f"bucket {bucket / testing.SAMPLE_RATE:.0f} s), "
                   f"{audio.decoder_backend()} decoder: decode {decode_s:.4f} s; "
                   f"cli.analyze_batch walls {[round(w, 4) for w in walls_files]} s (first cold), "
                   f"of the second: analyze {analyze_s:.4f} s, "
                   f"{B_REAL / walls_files[-1]:.2f} tracks/s from files on {card}; launches "
                   f"{file_launches}; cli.analyze_file: bpm {single.get('bpm')}, key "
                   f"{single.get('key')}, {single.get('processing_time_ms', 0.0):.0f} ms with "
                   f"decode; with --enable-key-ensemble true: key {ensemble.get('key')}; "
                   f"gates {gates}")
    if not all(gates.values()):
        fail(f"file-path gates failed: {gates}; records "
             f"{[(r.get('bpm'), r.get('key'), r.get('beat_count'), r.get('error')) for r in recs]}"
             f"; in memory {[(m.bpm, m.key.name(), len(m.beat_grid.beats)) for m in in_memory]}")

    mesh_stats = mesh_phase(port, card, batches, lengths, dev)
    del batches, adversarial, clean
    torch.cuda.empty_cache()
    battery_s, battery_launches = battery_phase(port, card)

    def entry(name, source, replaces, err, ms, plain_ms, bound):
        """One kernel's line: times measured above, the bound computed from
        this run's shapes and data, launches from the adversarial batch (and
        from the file path's batch). No single PyTorch call computes any of
        the eight functions, so there is no library time; the windowed
        median, the HPCP, the DFT's magnitudes and stage 1 of the key STFT
        replace no TPU kernel."""
        return {"name": name, "route": "cuda",
                "source": f"stratum_dsp_tpu_torch/csrc/{source}",
                "replaces": replaces and f"stratum_dsp_tpu/ops/{replaces}",
                "launches": main_launches[name], "launches_files": file_launches[name],
                "launches_battery": battery_launches[name],
                "launches_mesh_1d": mesh_stats["launches_mesh_1d"][name],
                "launches_mesh_2d": mesh_stats["launches_mesh_2d"][name],
                "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
                "bound_by": bound["bound_by"], "share_of_bound": bound["bound_ms"] / ms,
                "library_ms": None, "library_call": None}

    kernels = [
        entry("polyphase_stage2", "polyphase_stage2.cu", "polyphase_pallas.py:118",
              err_a, ms_a, plain_ms_a, bound_a),
        entry("downbeat_mask", "downbeat_mask.cu", "downbeats_pallas.py:59",
              err_b, ms_b["drawn"], plain_ms_b, bound_b["drawn"]),
        entry("viterbi_decode", "viterbi_decode.cu", "viterbi_pallas.py:108",
              err_c, ms_c["em"], plain_ms_c, bound_c["em"]),
        entry("fused_novelty_features", "fused_novelty.cu", "novelty_pallas.py:194",
              err_d, ms_d["base"], plain_ms_d["base"], bound_d["base"]),
        entry("window_median", "window_median.cu", None, 0.0, ms_m["time"], plain_ms_m["time"],
              bound_m["time"]),
        entry("hpcp_bisect", "hpcp_bisect.cu", None, err_h, ms_h[main_h[0]],
              plain_ms_h[main_h[0]], bound_h[main_h[0]]),
        entry("stft_magnitude", "stft_magnitude.cu", None, err_s, ms_s["base"],
              plain_ms_s["base"], bound_s["base"]),
        entry("poly_block_dft", "poly_block_dft.cu", None, err_p, ms_p["default"],
              plain_ms_p["default"], bound_p["default"]),
    ]
    kernels[7].update(wide_ms=ms_p["wide"], wide_plain_ms=plain_ms_p["wide"],
                      wide_bound_ms=bound_p["wide"]["bound_ms"], ulps=stats_p)
    kernels[6].update(escalation_ms=ms_s["escalation"],
                      escalation_plain_ms=plain_ms_s["escalation"],
                      escalation_bound_ms=bound_s["escalation"]["bound_ms"])
    kernels[5].update(single_ms=ms_h[main_h[1]], single_plain_ms=plain_ms_h[main_h[1]],
                      single_bound_ms=bound_h[main_h[1]]["bound_ms"],
                      launches_chunks=launched_h)
    kernels[4].update(frequency_ms=ms_m["frequency"], frequency_plain_ms=plain_ms_m["frequency"],
                      frequency_bound_ms=bound_m["frequency"]["bound_ms"], chroma_ms=ms_chroma)
    # B and C on their second input, and the empty launch of their grids
    kernels[1].update(main_ms=ms_b["main"], main_bound_ms=bound_b["main"]["bound_ms"],
                      empty_launch_ms=empty_b)
    kernels[2].update(steady_ms=ms_c["em_steady"],
                      steady_bound_ms=bound_c["em_steady"]["bound_ms"],
                      empty_launch_ms=empty_c)
    # B and C past shared memory, at a batch of two-hour mixes
    kernels[1].update(long_ms=ms_b_long, long_plain_ms=plain_ms_b_long,
                      long_bound_ms=bound_b_long["bound_ms"], long_empty_launch_ms=empty_b_long)
    kernels[2].update(long_ms=ms_c_long, long_plain_ms=plain_ms_c_long,
                      long_bound_ms=bound_c_long["bound_ms"], long_empty_launch_ms=empty_c_long)
    kernels[3].update(aux_ms=ms_d["aux"], aux_plain_ms=plain_ms_d["aux"],
                      aux_bound_ms=bound_d["aux"]["bound_ms"])
    # the opt-in shapes: A with every bin kept, D over a whole track, and the
    # launches of each opt-in config's real-size batch
    kernels[0].update(wide_ms=ms_a_wide, wide_plain_ms=plain_ms_a_wide,
                      wide_bound_ms=bound_a_wide["bound_ms"])
    kernels[3].update(whole_track_ms=ms_d_track, whole_track_plain_ms=plain_ms_d_track,
                      whole_track_bound_ms=bound_d_track["bound_ms"])
    for k in kernels:
        k["launches_opt_in"] = {name: o["launches"][k["name"]] for name, o in opt_in.items()}
    phase("total", f"{time.perf_counter() - t_start:.1f} s, the kernels' build included "
                   f"(the battery {battery_s:.1f} s of it)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
