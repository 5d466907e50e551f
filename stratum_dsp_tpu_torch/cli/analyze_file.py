"""Single-file analysis CLI (port of ``stratum_dsp_tpu/cli/analyze_file.py``).

Mirror of the reference's ``analyze_file`` example (examples/analyze_file.rs):
decode -> analyze -> JSON on stdout. Config flags map 1:1 onto
``AnalysisConfig`` (auto-generated from the dataclass). The analysis runs on
the current CUDA device unless ``--device`` names another (``--device cpu``
for the CPU).

Usage: python -m stratum_dsp_tpu_torch.cli.analyze_file track.wav --json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import tracing
from ..analysis import PipelineCaps, analyze_batch_timed, decode_results
from ..analysis.debug import emit_debug_dump
from ..io.decode import MIX_AVERAGE, MIX_DOMINANT, decode_file
from .args import add_config_flags, add_device_flag, config_from_args, setup_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Analyze one audio file (BPM + key + beat grid)")
    p.add_argument("path", help="audio file (wav/mp3)")
    p.add_argument("--json", action="store_true", help="emit JSON (default: human-readable)")
    p.add_argument("--target-sample-rate", type=int, default=0, help="resample before analysis")
    p.add_argument("--mix-mode", choices=["average", "dominant"], default="average")
    p.add_argument("--max-onsets", type=int, default=2048)
    p.add_argument("--max-beats", type=int, default=1024)
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="-v: stage INFO logs, -vv: DEBUG batch summaries")
    add_device_flag(p)
    add_config_flags(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose)
    cfg = config_from_args(args)
    mix = MIX_DOMINANT if args.mix_mode == "dominant" else MIX_AVERAGE

    t0 = time.time()
    with tracing.span("cli.decode", files=1):
        samples, sr = decode_file(args.path, args.target_sample_rate, mix)
    if samples.size == 0:
        print(json.dumps({"error": "empty audio"}), file=sys.stderr)
        return 1

    caps = PipelineCaps(max_onsets=args.max_onsets, max_beats=args.max_beats)
    out = analyze_batch_timed(samples[None, :], np.asarray([len(samples)]), cfg, sr, caps,
                              device=args.device)
    result = decode_results(out, sr)[0]
    # total incl. decode + host assembly (lib.rs:91-92 semantics)
    result.metadata.processing_time_ms = (time.time() - t0) * 1000.0
    emit_debug_dump(out, cfg, 0)

    if args.json:
        print(json.dumps(result.to_dict()))
    else:
        d = result.to_dict()
        print(f"file: {args.path}")
        print(f"bpm: {d['bpm']:.2f} (confidence {d['bpm_confidence']:.3f})")
        print(f"key: {d['key']} / {d['key_numerical']} "
              f"(confidence {d['key_confidence']:.3f}, clarity {d['key_clarity']:.3f})")
        print(f"grid: {d['beat_count']} beats, {d['downbeat_count']} downbeats, "
              f"stability {d['grid_stability']:.3f}")
        print(f"duration: {d['duration_seconds']:.2f}s  "
              f"processing: {d['processing_time_ms']:.0f}ms")
        if d["flags"]:
            print("flags:", ", ".join(d["flags"]))
        for w in d["confidence_warnings"]:
            print("warning:", w)
    return 0


if __name__ == "__main__":
    sys.exit(main())
