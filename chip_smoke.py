#!/usr/bin/env python3
"""Quickest proof that the PyTorch port of stratum_dsp_tpu runs on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``stratum_dsp_tpu_torch/csrc`` and
drives the port (``stratum_dsp_tpu_torch.analyze_batch``) in these phases,
one line each:

1. device: a CUDA card is required; prints its name and power limit;
2. build: one ``nvcc`` per source for sm_90a, all at once, with the time;
3-6. each kernel against its plain PyTorch version on the card at the main
   path's shapes, with both times: A (polyphase stage 2) bit for bit, B
   (downbeat walk) and C (Viterbi decode, with rows that underflow) exactly,
   D (fused novelty reducer, base and auxiliary variants) within 1e-5 of
   each output group's largest value;
7. fixture batches through the port on the CPU (plain versions) and on the
   card (kernels), compared output by output
   (``stratum_dsp_tpu_torch.testing.assert_outputs_match``): the slice batch
   under ``SLICE_CONFIG``, and under the default config kicks that take
   every branch of the multi-resolution escalation;
8. 40 tracks x 180 s at 44.1 kHz with the default capacities under
   ``SLICE_CONFIG``: one counted and gated batch after a warm-up;
9-10. the same size under the default ``AnalysisConfig``, for the clean mix
   (32 kicks + 8 C-major scales) and the adversarial mix (28 core kicks, 12
   in the escalation's trap zones): a warm-up, then five timed batches
   (median and spread of tracks/s); the first is the one whose kernel
   launches are counted and whose outputs are gated (exact BPM on core
   kicks, family-exact on trap kicks, scales in C, beats and downbeats on
   every track, the escalation used on the adversarial mix); then one
   adversarial batch with stage timers.

Then one JSON line with the kernels, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
result line. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
B_REAL, SECONDS_REAL = 40, 180.0
TIMED_BATCHES = 5  # host-side gaps make single batches spread by ~20%


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def stage_timers():
    """Time the pipeline's stages, each between two synchronisations, while
    the block runs; yields {stage: [ms per call]}."""
    import torch
    from stratum_dsp_tpu_torch.analysis import pipeline
    from stratum_dsp_tpu_torch.features.period import novelty

    targets = [(pipeline, "detect_energy_flux_onsets", "energy onsets"),
               (novelty, "compute_bpm_spectral_features", "BPM STFT + reducer"),
               (pipeline, "_escalate", "escalation"),
               (pipeline, "generate_beat_grid", "beat grid"),
               (pipeline, "detect_key_batch", "key path")]
    times, originals = {}, []

    def timed(fn, label):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times.setdefault(label, []).append(1000.0 * (time.perf_counter() - t0))
            return out
        return wrapper

    for module, attr, label in targets:
        originals.append((module, attr, getattr(module, attr)))
        setattr(module, attr, timed(getattr(module, attr), label))
    try:
        yield times
    finally:
        for module, attr, fn in originals:
            setattr(module, attr, fn)


def main() -> int:
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
    from stratum_dsp_tpu_torch import testing
    from stratum_dsp_tpu_torch.features.period.novelty import novelty_tables
    from stratum_dsp_tpu_torch.ops import cuda_build
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
    lib_path, build_s = cuda_build.build(verbose=True)
    cuda_build.library()
    phase("build", f"{lib_path.name} built in {build_s:.1f} s (0.0 = already built)")

    # 3. kernel A at the main path's shape: B=40, _auto_chunk -> 192-frame
    # chunks, ext = 192 + 2*12 = 216, EBP = 240, KP = 1024, keep = 931
    r, ext, keep, kp = 16, 216, 931, 1024
    ebp = -(-(ext + r) // r) * r
    rng = np.random.default_rng(7)
    bd = torch.as_tensor(rng.standard_normal((B_REAL, ebp, 2 * kp), np.float32) * 4.0,
                         device=dev).to(torch.bfloat16)
    got = polyphase_stage2(bd, r, ext, keep)
    torch.cuda.synchronize()
    ref = polyphase_stage2_plain(bd, r, ext, keep)
    # same rounding points and summation order, no FMA contraction: bit-equal
    err_a = float((got.float() - ref.float()).abs().max())
    if not torch.equal(got, ref):
        fail(f"kernel A is not bit-equal to its plain version: max|d| = {err_a}")
    ms_a = cuda_time_ms(lambda: polyphase_stage2(bd, r, ext, keep), 50)
    plain_ms_a = cuda_time_ms(lambda: polyphase_stage2_plain(bd, r, ext, keep), 10)
    phase("kernel A", f"polyphase_stage2 [{B_REAL},{ebp},{2 * kp}] bf16 -> [{B_REAL},{ext},"
                      f"{keep}]: bit-equal to the plain version; "
                      f"kernel {ms_a:.4f} ms, plain {plain_ms_a:.4f} ms")

    # 4. kernel B at the main path's shape: N = max(max_segments*seg_beat_cap,
    # max_beats) = 3072 beat slots with the default capacities
    caps = port.PipelineCaps()
    n = max(caps.max_segments * caps.seg_beat_cap, caps.max_beats)
    bar = torch.as_tensor(rng.uniform(1.2, 3.0, B_REAL).astype(np.float32), device=dev)
    step = bar / 4.0
    times = torch.cumsum(step[:, None] * torch.as_tensor(
        rng.uniform(0.9, 1.1, (B_REAL, n)).astype(np.float32), device=dev), dim=1)
    # rows 0-3 land beats exactly on the +-10% edges of one bar
    for row, sign in ((0, 1.0), (1, -1.0), (2, 1.0), (3, -1.0)):
        k = torch.arange(n, device=dev, dtype=torch.float32)
        times[row] = k * (bar[row] * (1.0 + sign * 0.1) / 4.0)
    n_beats = torch.as_tensor(rng.integers(1, n, B_REAL), device=dev, dtype=torch.int32)
    n_beats[0], n_beats[1], n_beats[4], n_beats[5] = n, n, 0, n
    got_b = downbeat_mask(times, n_beats, bar)
    torch.cuda.synchronize()
    ref_b = downbeat_mask_plain(times, n_beats, bar)
    err_b = float((got_b.float() - ref_b.float()).abs().max())
    if not torch.equal(got_b, ref_b):
        fail(f"kernel B disagrees with its plain version in "
             f"{int((got_b != ref_b).sum())} slots")
    ms_b = cuda_time_ms(lambda: downbeat_mask(times, n_beats, bar), 50)
    plain_ms_b = cuda_time_ms(lambda: downbeat_mask_plain(times, n_beats, bar), 2)
    phase("kernel B", f"downbeat_mask [{B_REAL},{n}]: exact ({int(got_b.sum())} downbeats); "
                      f"kernel {ms_b:.4f} ms, plain {plain_ms_b:.4f} ms")

    # 5. kernel C at the main path's shape: B=40, max_beats=1024 beat slots;
    # uniform rows, a row of 1e-3 that underflows through denormals to 0,
    # and a row with a zero tail
    em = torch.as_tensor(rng.uniform(0.01, 1.0, (B_REAL, caps.max_beats)).astype(np.float32),
                         device=dev)
    em[0] = 1e-3
    em[1, 300:] = 0.0
    em[2, :300], em[2, 300:] = 1e-3, 0.0
    got_c = viterbi_decode(em)
    torch.cuda.synchronize()
    ref_c = viterbi_decode_plain(em)
    err_c = float((got_c - ref_c).abs().max())
    if not torch.equal(got_c, ref_c):
        fail(f"kernel C disagrees with its plain version in {int((got_c != ref_c).sum())} slots")
    ms_c = cuda_time_ms(lambda: viterbi_decode(em), 50)
    plain_ms_c = cuda_time_ms(lambda: viterbi_decode_plain(em), 2)
    phase("kernel C", f"viterbi_decode [{B_REAL},{caps.max_beats}]: exact; "
                      f"kernel {ms_c:.4f} ms, plain {plain_ms_c:.4f} ms")

    # 6. kernel D at the main path's shape: B=40, 256-frame chunks of the
    # 2048-point BPM STFT; the base pass's variant and the hop-256 pass's
    tables = novelty_tables(port.AnalysisConfig(), testing.SAMPLE_RATE, 2048)
    spec = torch.as_tensor(rng.random((B_REAL, 256, tables.n_bins), np.float32) * 3.0, device=dev)
    spec[5, 100:] = 0.0  # the zeroed frames past a track's end
    prev2 = torch.as_tensor(rng.random((B_REAL, 2, tables.n_bins), np.float32), device=dev)
    err_d, ms_d, plain_ms_d = 0.0, {}, {}
    for variant, (s2, onset) in (("base", (True, True)), ("aux", (False, False))):
        flags = dict(emit_stride2=s2, emit_onset=onset, use_mel=True)
        got_d = fused_novelty_features(spec, prev2, tables, **flags)
        torch.cuda.synchronize()
        ref_d = fused_novelty_features_plain(spec, prev2, tables, **flags)
        err_d = max(err_d, float((got_d - ref_d).abs().max()))
        # summation order differs from the plain version's: 1e-5 of each
        # output group's largest value, the JAX package's own bound
        unpack = lambda x: unpack_features(x, tables.nb, tables.nm, s2, onset, True)  # noqa: E731
        groups = {k: (unpack(got_d)[k], v) for k, v in unpack(ref_d).items()}
        rel = {k: float((g - r).abs().max() / r.abs().max().clamp_min(1e-12))
               for k, (g, r) in groups.items()}
        if max(rel.values()) >= 1e-5:
            fail(f"kernel D ({variant}) is off its plain version: relative errors {rel}")
        ms_d[variant] = cuda_time_ms(lambda: fused_novelty_features(spec, prev2, tables, **flags),
                                     50)
        plain_ms_d[variant] = cuda_time_ms(
            lambda: fused_novelty_features_plain(spec, prev2, tables, **flags), 10)
        phase("kernel D", f"fused_novelty_features {variant} [{B_REAL},256,{tables.n_bins}] -> "
                          f"[{B_REAL},256,128]: largest relative error per group "
                          f"{max(rel.values()):.3g}; kernel {ms_d[variant]:.4f} ms, "
                          f"plain {plain_ms_d[variant]:.4f} ms")

    # 7. fixture batches, CPU (plain versions) vs card (kernels): the slice
    # batch under SLICE_CONFIG, and under the default config a batch that
    # takes every branch of the escalation
    fixture = [testing.kick_patterns([120.0], 8.0)[0], testing.kick_patterns([128.0], 7.5)[0],
               testing.c_major_scale(), testing.silence_sandwich(5.0, 5.0)]
    samples, lengths = testing.pad_batch(fixture)
    out_cpu = port.analyze_batch(samples, lengths, port.SLICE_CONFIG)
    out_gpu = port.analyze_batch(samples.to(dev), lengths.to(dev), port.SLICE_CONFIG)
    torch.cuda.synchronize()
    # the silence sandwich (track 3) is a steady tone: its tempogram
    # confidences ride on the BPM STFT matmul's accumulation order (cuBLAS
    # here, MKL or oneDNN on the CPU) and are held to the noise-floor bound
    worst = testing.assert_outputs_match(out_cpu, out_gpu, noise_floor_track=3)
    phase("slice cpu/gpu", f"{len(out_cpu)} outputs agree on the fixture batch "
                           f"(largest float difference {worst[1]:.3g} in {worst[0]})")
    samples = testing.kick_patterns([75.0, 120.0, 128.0, 172.0], 8.0)
    lengths = torch.full((4,), samples.shape[1], dtype=torch.int64)
    out_cpu = port.analyze_batch(samples, lengths)
    out_gpu = port.analyze_batch(samples.to(dev), lengths.to(dev))
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
    lengths = torch.full((B_REAL,), n_samples, dtype=torch.int64, device=dev)
    scale = testing.c_major_scale(device=dev)
    scale = scale.repeat(-(-n_samples // scale.shape[0]))[:n_samples]

    def make_batch(seeds):
        kicks = testing.kick_patterns(seeds, SECONDS_REAL, device=dev)
        rest = scale[None, :].expand(B_REAL - len(seeds), n_samples)
        return torch.cat([kicks, rest], dim=0)

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

    def want_launches(escalated: bool, cfg_multires: bool = True):
        """Launches of one batch: the key STFT's 81 chunks, one downbeat walk,
        one decode, a reducer launch per BPM chunk (and per hop-256 chunk
        when a track escalates)."""
        d = n_chunks(512) + (n_chunks(256) if escalated and cfg_multires else 0)
        return {"polyphase_stage2": 81, "downbeat_mask": 1, "viterbi_decode": 1,
                "fused_novelty_features": d}

    def gates_for(res, seeds, core, launches):
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
            "launches": launches == want_launches(bool(res["multi_res_triggered"].any())),
        }
        return gates, res, bpm

    # 8. the slice's path (SLICE_CONFIG, multi-resolution off), one counted batch
    seeds = np.round(np.linspace(85, 168, 32)).astype(np.float32)
    clean = make_batch(seeds)
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

    # 9-10. the default config on both mixes: a warm-up, then five timed
    # batches; the first is the one whose launches are counted and gated
    adv_seeds = np.concatenate([np.round(np.linspace(85.0, 168.0, 28)),
                                np.round(np.linspace(56.0, 79.0, 6)),
                                np.round(np.linspace(172.0, 199.0, 6))]).astype(np.float32)
    mixes = (("clean", seeds, make_batch(seeds), np.ones(32, bool)),
             ("adversarial", adv_seeds, make_batch(adv_seeds), np.arange(40) < 28))
    main_launches, rates_by_mix = None, {}
    for name, mix_seeds, batch, core in mixes:
        run(batch, port.AnalysisConfig())  # warm-up
        out, wall, launches = run(batch, port.AnalysisConfig())
        walls = [wall] + [run(batch, port.AnalysisConfig())[1] for _ in range(TIMED_BATCHES - 1)]
        rates = sorted(B_REAL / w for w in walls)
        rates_by_mix[name] = float(np.median(rates))
        gates, res, bpm = gates_for(out, mix_seeds, core, launches)
        n_trig, n_used = int(res["multi_res_triggered"].sum()), int(res["multi_res_used"].sum())
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

    # where the time goes on the adversarial mix: one more batch with each
    # stage synchronised (the BPM STFT line counts the base pass and, inside
    # the escalation, the hop-256 pass)
    with stage_timers() as stages:
        _, wall, _ = run(mixes[1][2], port.AnalysisConfig())
    phase("stages, adversarial", f"batch {wall * 1000:.1f} ms; " + "; ".join(
        f"{k} {[round(t, 1) for t in v]} ms" for k, v in stages.items()))

    kernels = [
        {"name": "polyphase_stage2", "route": "cuda",
         "source": "stratum_dsp_tpu_torch/csrc/polyphase_stage2.cu",
         "replaces": "stratum_dsp_tpu/ops/polyphase_pallas.py:118",
         "launches": main_launches["polyphase_stage2"], "max_abs_err": err_a,
         "ms": ms_a, "plain_ms": plain_ms_a},
        {"name": "downbeat_mask", "route": "cuda",
         "source": "stratum_dsp_tpu_torch/csrc/downbeat_mask.cu",
         "replaces": "stratum_dsp_tpu/ops/downbeats_pallas.py:59",
         "launches": main_launches["downbeat_mask"], "max_abs_err": err_b,
         "ms": ms_b, "plain_ms": plain_ms_b},
        {"name": "viterbi_decode", "route": "cuda",
         "source": "stratum_dsp_tpu_torch/csrc/viterbi_decode.cu",
         "replaces": "stratum_dsp_tpu/ops/viterbi_pallas.py:108",
         "launches": main_launches["viterbi_decode"], "max_abs_err": err_c,
         "ms": ms_c, "plain_ms": plain_ms_c},
        {"name": "fused_novelty_features", "route": "cuda",
         "source": "stratum_dsp_tpu_torch/csrc/fused_novelty.cu",
         "replaces": "stratum_dsp_tpu/ops/novelty_pallas.py:194",
         "launches": main_launches["fused_novelty_features"], "max_abs_err": err_d,
         "ms": ms_d["base"], "plain_ms": plain_ms_d["base"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
