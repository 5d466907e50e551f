"""Tempogram tuning grid sweep (the port's twin of
``validation/tools/sweep_tempogram_tuning.py``): run a validation batch CSV
over a grid of config overrides and print a leaderboard by +-2 BPM accuracy,
then MAE, as JSON.

Tracks are bucketed as ``run_validation`` buckets them (``bucket_for``), so
a track gets the padded shape, and so the result, it gets there. The
analysis runs on the current CUDA device unless ``--device`` names another
(``--device cpu`` for the CPU).

Usage:
    python -m stratum_dsp_tpu_torch.validation.sweep_tempogram_tuning batch.csv \
        --param tempogram_band_consensus_bonus 0.0 0.08 0.15 \
        --param tempogram_mel_weight 0.10 0.15 0.25 [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import numpy as np

from ..analysis import PipelineCaps, analyze_batch, decode_results
from ..cli.args import add_device_flag
from ..config import AnalysisConfig
from ..io.decode import decode_batch
from .run_validation import SR, bucket_for, load_batch_csv


def run_config(cfg: AnalysisConfig, decoded, rows, batch_size: int = 8, *, device=None) -> dict:
    """Analyze the decoded tracks under ``cfg``; returns the +-2 BPM accuracy
    ``acc2``, the mean absolute BPM error ``mae`` and the count ``n`` over
    the rows that have a ground-truth BPM."""
    groups: dict[int, list[int]] = {}
    for i, (samples, _sr, err) in enumerate(decoded):
        if err is None and samples is not None and samples.size:
            groups.setdefault(bucket_for(len(samples)), []).append(i)
    results = {}
    caps = PipelineCaps()
    for bucket_len, idxs in sorted(groups.items()):
        for s in range(0, len(idxs), batch_size):
            chunk = idxs[s:s + batch_size]
            batch = np.zeros((len(chunk), bucket_len), np.float32)
            lengths = np.zeros((len(chunk),), np.int32)
            for j, i in enumerate(chunk):
                x = decoded[i][0][:bucket_len]
                batch[j, :len(x)] = x
                lengths[j] = len(x)
            out = analyze_batch(batch, lengths, cfg, SR, caps, device=device)
            results.update(zip(chunk, decode_results(out, SR)))
    errs = np.asarray([abs(results[i].bpm - float(row["bpm"]))
                       for i, row in enumerate(rows) if i in results and row.get("bpm")])
    return {
        "acc2": round(float(np.mean(errs <= 2.0)), 4) if len(errs) else 0.0,
        "mae": round(float(errs.mean()), 3) if len(errs) else None,
        "n": len(errs),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("batch_csv")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument(
        "--param", nargs="+", action="append", metavar=("NAME", "VALUES"),
        help="config field followed by values to sweep", default=[],
    )
    add_device_flag(p)
    args = p.parse_args(argv)

    rows = load_batch_csv(args.batch_csv, args.limit)
    decoded = decode_batch([r["file"] for r in rows], target_sr=SR)

    base = AnalysisConfig()
    sweeps = []
    for spec in args.param:
        name, values = spec[0], spec[1:]
        cur = getattr(base, name)
        cast = type(cur) if not isinstance(cur, bool) else (lambda v: v.lower() == "true")
        sweeps.append((name, [cast(v) for v in values]))
    if not sweeps:
        sweeps = [("tempogram_band_consensus_bonus", [0.0, 0.08])]

    board = []
    for combo in itertools.product(*[v for _, v in sweeps]):
        overrides = {name: val for (name, _), val in zip(sweeps, combo)}
        score = run_config(base.replace(**overrides), decoded, rows, args.batch_size,
                           device=args.device)
        board.append({**overrides, **score})
        print(json.dumps(board[-1]), file=sys.stderr)

    board.sort(key=lambda r: (-(r["acc2"] or 0), r["mae"] or 1e9))
    print(json.dumps(board, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
