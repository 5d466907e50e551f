"""Batch analysis CLI: the throughput path (port of
``stratum_dsp_tpu/cli/analyze_batch.py``).

Mirror of the reference's ``analyze_batch`` example
(examples/analyze_batch.rs): many files -> JSONL, with a wall-clock /
throughput summary. Unlike the reference's rayon thread pool over
single-threaded analyses, this pipeline is batch-first: the native decode
pool fills padded ``[B, T]`` buckets that run through the device pipeline one
bucket at a time, on the current CUDA device unless ``--device`` names
another (``--device cpu`` for the CPU).

Usage: python -m stratum_dsp_tpu_torch.cli.analyze_batch tracks/*.wav -o out.jsonl
"""

from __future__ import annotations

import argparse
import contextlib
import contextvars
import json
import sys
import threading
import time
from queue import Queue

import numpy as np

from .. import tracing
from ..analysis import PipelineCaps, analyze_batch_timed, decode_results
from ..io.decode import decode_batch
from .args import add_config_flags, add_device_flag, config_from_args, setup_logging

# Bucket boundaries (seconds) to bound padding waste; tracks land in the
# smallest bucket that fits, longest are truncated to the max bucket.
DEFAULT_BUCKETS = (60.0, 120.0, 240.0, 420.0)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Analyze a batch of audio files (JSONL out)")
    p.add_argument("paths", nargs="+", help="audio files")
    p.add_argument("-o", "--output", default="-", help="JSONL output path (default stdout)")
    p.add_argument("--batch-size", type=int, default=40, help="tracks per device batch")
    p.add_argument("--target-sample-rate", type=int, default=44100)
    p.add_argument("--decode-threads", type=int, default=0, help="0 = CPU count - 1")
    p.add_argument("--max-onsets", type=int, default=2048)
    p.add_argument("--max-beats", type=int, default=1024)
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="-v: stage INFO logs, -vv: DEBUG batch summaries")
    add_device_flag(p)
    add_config_flags(p)
    return p


def bucket_for(n_samples: int, sr: int, buckets=DEFAULT_BUCKETS) -> int:
    secs = n_samples / sr
    for b in buckets:
        if secs <= b:
            return int(b * sr)
    return int(buckets[-1] * sr)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose)
    cfg = config_from_args(args)
    caps = PipelineCaps(max_onsets=args.max_onsets, max_beats=args.max_beats)
    sr = args.target_sample_rate
    t_start = time.time()

    # decode/analyze overlap: a host thread decodes chunk k+1 while the
    # device analyzes chunk k (the reference's rayon pool analogue with the
    # device as the consumer)
    chunks = [list(range(i, min(i + args.batch_size, len(args.paths))))
              for i in range(0, len(args.paths), args.batch_size)]
    decode_q: Queue = Queue(maxsize=2)

    def decoder():
        for chunk in chunks:
            paths = [args.paths[i] for i in chunk]
            with tracing.span("cli.decode", files=len(paths)):
                decoded = decode_batch(paths, target_sr=sr, n_threads=args.decode_threads)
            decode_q.put((chunk, decoded))
        decode_q.put(None)

    n_ok = 0
    with contextlib.ExitStack() as stack:
        stack.enter_context(tracing.span("cli.batch", files=len(args.paths)))
        # the decode thread runs in a copy of this context: its spans are the
        # batch's children
        threading.Thread(target=contextvars.copy_context().run, args=(decoder,),
                         daemon=True).start()
        out_fh = sys.stdout if args.output == "-" else stack.enter_context(
            open(args.output, "w"))
        while True:
            with tracing.span("cli.wait"):
                item = decode_q.get()
            if item is None:
                break
            chunk, decoded = item
            # split by padded bucket length so batch shapes stay bounded
            with tracing.span("cli.assemble"):
                sub: dict[int, list[int]] = {}
                for j, (samples, _sr, err) in enumerate(decoded):
                    if err is not None or samples is None or samples.size == 0:
                        rec = {"file": args.paths[chunk[j]], "error": err or "empty audio"}
                        out_fh.write(json.dumps(rec) + "\n")
                        continue
                    sub.setdefault(bucket_for(len(samples), sr), []).append(j)
            for bucket_len, js in sorted(sub.items()):
                with tracing.span("cli.assemble"):
                    b = len(js)
                    batch = np.zeros((b, bucket_len), np.float32)
                    lengths = np.zeros((b,), np.int32)
                    for k, j in enumerate(js):
                        s = decoded[j][0][:bucket_len]
                        batch[k, : len(s)] = s
                        lengths[k] = len(s)
                out = analyze_batch_timed(batch, lengths, cfg, sr, caps, device=args.device)
                with tracing.span("cli.results"):
                    results = decode_results(out, sr)
                    for k, j in enumerate(js):
                        rec = {"file": args.paths[chunk[j]], **results[k].to_dict()}
                        out_fh.write(json.dumps(rec) + "\n")
                        n_ok += 1

    wall = time.time() - t_start
    print(f"analyzed {n_ok}/{len(args.paths)} tracks in {wall:.1f}s "
          f"({n_ok / max(wall, 1e-9):.2f} tracks/sec)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
