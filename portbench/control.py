#!/usr/bin/env python3
"""The readings that a cell's limits are set from: for each seed, the port's
answers (``--program``) and the control's against the plain reference, at
the cell's own size, each input of the cell answered once.

    python3 portbench/control.py --workload default.adversarial --seeds 11,12,13 --program

The control is the reference put in the port's place under
``reference.lower_precision`` (every float32 matrix product in bfloat16).
One JSON line a seed: ``{"seed", "program", "control"}``, each the numbers
of ``compare.py``. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(root: Path, workload: str, seed: int, device, program: bool,
             overrides=None, log=None) -> dict:
    import torch

    from portbench import drivers, harness

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    files = harness.cell_files(harness.load_manifest(root), workload)
    for part, values in (overrides or {}).items():
        getattr(files, part).update(values)
    driver = drivers.DRIVERS[files.mix["driver"]]()
    run = harness.Run(files, seed, torch.device(device), log)
    out = {"seed": seed}
    try:
        driver.setup(run)
        if program:
            driver.once(run, None if files.mix["driver"] == "files" else
                        lambda s, n: drivers._to_host(drivers._analyze(run, s, n)))
            tally = driver.reference(run)
            out["program"], out["program_widest"] = tally.numbers(), tally.widest()
        driver.once(run, lambda s, n: run.reference_outputs(s, n, lower_precision=True))
        tally = driver.reference(run)
        out["control"], out["control_widest"] = tally.numbers(), tally.widest()
    finally:
        run.close()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--program", action="store_true", help="read the port's numbers too")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = readings(ROOT, args.workload, seed, "cuda:0", args.program)
        res["seconds"] = time.perf_counter() - t0
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
