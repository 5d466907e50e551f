"""CLI flag plumbing: AnalysisConfig fields -> argparse flags (1:1); the
port's copy of ``stratum_dsp_tpu/cli/args.py``, over the port's own
``AnalysisConfig``, plus the flags both CLIs share.

The reference's ``analyze_file`` exposes ~100 tuning flags mapping directly
onto ``AnalysisConfig`` (examples/analyze_file.rs:186). Here the mapping is
generated from the dataclass, so every config field (current and future) is
reachable from the command line as ``--<field-name-with-dashes>``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from typing import Any

from ..config import AnalysisConfig, NormalizationMethod, TemplateSet


def _parse_bool(v: str) -> bool:
    s = v.strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def add_config_flags(parser: argparse.ArgumentParser) -> None:
    group = parser.add_argument_group("analysis config (mirrors AnalysisConfig)")
    for f in dataclasses.fields(AnalysisConfig):
        flag = "--" + f.name.replace("_", "-")
        default = getattr(AnalysisConfig(), f.name)
        if f.type in ("bool", bool) or isinstance(default, bool):
            group.add_argument(flag, type=_parse_bool, default=None, metavar="BOOL",
                               help=f"(default: {default})")
        elif isinstance(default, NormalizationMethod):
            group.add_argument(flag, choices=[m.value for m in NormalizationMethod],
                               default=None, help=f"(default: {default.value})")
        elif isinstance(default, TemplateSet):
            group.add_argument(flag, choices=[m.value for m in TemplateSet],
                               default=None, help=f"(default: {default.value})")
        elif isinstance(default, int):
            group.add_argument(flag, type=int, default=None, help=f"(default: {default})")
        elif isinstance(default, float):
            group.add_argument(flag, type=float, default=None, help=f"(default: {default})")
        elif isinstance(default, tuple):
            group.add_argument(flag, type=str, default=None,
                               help=f"comma-separated (default: {','.join(map(str, default))})")
        else:  # Optional[...] fields
            group.add_argument(flag, type=str, default=None, help="(default: none)")


def config_from_args(args: argparse.Namespace) -> AnalysisConfig:
    overrides: dict[str, Any] = {}
    base = AnalysisConfig()
    for f in dataclasses.fields(AnalysisConfig):
        v = getattr(args, f.name, None)
        if v is None:
            continue
        default = getattr(base, f.name)
        if isinstance(default, NormalizationMethod):
            v = NormalizationMethod(v)
        elif isinstance(default, TemplateSet):
            v = TemplateSet(v)
        elif isinstance(default, tuple):
            parts = [p for p in str(v).split(",") if p.strip()]
            elem = float if (default and isinstance(default[0], float)) else int
            v = tuple(elem(p) for p in parts)
        elif f.name == "debug_track_id":
            v = int(v)
        elif f.name == "debug_gt_bpm":
            v = float(v)
        overrides[f.name] = v
    return base.replace(**overrides)


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default=None,
                        help="where the analysis runs: a CUDA device such as cuda:0, or cpu "
                             "(default: the current CUDA device; without a card the run "
                             "fails unless --device cpu is given)")


def setup_logging(verbose: int) -> None:
    """-v: stage INFO logs, -vv: DEBUG batch summaries, on stderr."""
    if not verbose:
        return
    level = logging.DEBUG if verbose > 1 else logging.INFO
    logging.basicConfig(level=level, format="%(asctime)s %(name)s %(levelname)s %(message)s",
                        stream=sys.stderr)
    logging.getLogger("stratum_dsp_tpu_torch").setLevel(level)
