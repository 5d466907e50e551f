#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 portbench/run.py --workload default.adversarial --seed 7 --seconds 30 --trace 0

From the root of a checkout. The run makes its tracks on the card from the
seed, warms every shape the cell uses (set-up), sends the cell's traffic to
``stratum_dsp_tpu_torch`` in a closed loop for ``--seconds`` (the window),
holds every answer of the window to the plain reference under
``portbench/reference/``, and prints one JSON line last on standard output:
the end-to-end metrics with ``--trace 0``, the per-layer metrics of a traced
window with ``--trace 1``. The numbers compared, each beside its limit, are
the last lines on standard error and the ``checks`` of that line.

It exits non-zero and prints no result where no CUDA card is present, and
where a module of JAX or of the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed place inside the checkout
CACHE = ROOT / ".portbench_cache"
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(CACHE / _sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA card: the benchmark measures the card and does not fall back to the "
              "CPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    try:
        result, checks = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                          bool(args.trace), "cuda:0", T_START)
    except harness.CellError as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 3
    found = harness.banned_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in checks:
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
