"""One run of one cell: set-up, the window, the per-layer readers, the
comparison with the plain reference, the result line.

Everything that belongs to one configuration, mix, cell or per-layer metric
lives in a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: ``analysis_config`` (overrides of the port's
  ``AnalysisConfig``), ``pipeline_caps``, ``sample_rate``, ``batch_size``;
* ``traffic/<mix>.json``: the mix's numbers and its ``driver``
  (``traffic.py``, ``drivers.py``);
* ``limits/<cell>.json``: the limit of each number ``compare.py`` takes;
* ``metrics/<metric>.py``: a ``read(ctx)`` that returns the metric's value
  or None.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import compare, drivers, synth
from . import trace as trace_mod

HERE = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "stratum_dsp_tpu")


class CellError(RuntimeError):
    """A cell that cannot run as its files describe it."""


def load_manifest(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell_files(manifest: dict, workload: str) -> SimpleNamespace:
    """The cell's entry, configuration, mix, limits and metric names."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}

    def load(path):
        with open(path) as fh:
            return json.load(fh)

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    end_to_end = [m for m in manifest["end_to_end"] if applies(m)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in manifest["per_layer"] if applies(m) and m["moves"] in reported]
    return SimpleNamespace(
        cell=cell, config=load(HERE.parent / configs[cell["config"]]["file"]),
        mix=load(HERE / "traffic" / f"{cell['traffic']}.json"),
        limits=load(HERE / "limits" / f"{workload}.json")["limits"],
        end_to_end=end_to_end, per_layer=per_layer)


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Run:
    """What the drivers and readers of one run share."""

    def __init__(self, files, seed: int, device: torch.device, log):
        import stratum_dsp_tpu_torch as port

        self.config, self.mix = files.config, files.mix
        self.seed, self.rng = seed, np.random.default_rng(seed)
        self.device, self.log = device, log
        self.sample_rate = int(self.config.get("sample_rate", synth.SAMPLE_RATE))
        self.port = port
        self.port_cfg = port.AnalysisConfig.from_dict(self.config.get("analysis_config", {}))
        self.port_caps = port.PipelineCaps(**self.config.get("pipeline_caps", {}))
        self._scratch = None

    def setup_done_inputs(self) -> None:
        """The inputs are made: from here the device's peak is the program's."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.inputs_done = time.perf_counter()

    def scratch_dir(self) -> Path:
        if self._scratch is None:
            self._scratch = Path(tempfile.mkdtemp(prefix="portbench-"))
        return self._scratch

    def close(self) -> None:
        if self._scratch is not None:
            shutil.rmtree(self._scratch, ignore_errors=True)

    def reference_outputs(self, samples, lengths, lower_precision: bool = False) -> dict:
        """The plain reference's result arrays for one batch; with
        ``lower_precision`` under the control's arithmetic."""
        from . import reference

        if lower_precision:
            with reference.lower_precision():
                return reference.analyze(samples, lengths, self.config, self.sample_rate)
        return reference.analyze(samples, lengths, self.config, self.sample_rate)

    def _tempo_hit(self, spec, bpm: float) -> bool:
        if spec["zone"] == "core":
            return abs(bpm - spec["bpm"]) <= 2.0
        return any(abs(bpm - spec["bpm"] * m) <= 2.0 for m in (1.0, 2.0, 0.5))

    def report_gates(self, specs, host: dict) -> None:
        """How the answers stand against the tracks' known tempo and key (an
        earlier line on standard error; not part of ``correct``)."""
        tempo = [self._tempo_hit(s, float(host["bpm"][i])) for i, s in enumerate(specs)]
        key = [int(host["key_idx"][i]) == s["key"] for i, s in enumerate(specs)]
        self.log(f"gates: tempo {sum(tempo)}/{len(specs)}, key {sum(key)}/{len(specs)}, "
                 f"escalated {int(np.sum(host['multi_res_triggered']))}")

    def report_differences(self, batch: int, where: set, got: dict, ref: dict) -> None:
        """An earlier line on standard error for each track whose discrete
        outputs differ from the reference's: which, and the track's BPM and
        beat counts on both sides."""
        tracks = sorted({t for t, _ in where})
        for t in tracks[:8]:
            keys = sorted(k for tt, k in where if tt == t)
            self.log(f"differs: input {batch} track {t}: {keys}; bpm {float(got['bpm'][t])!r} / "
                     f"{float(ref['bpm'][t])!r}; beats {int(got['beat_valid'][t].sum())} / "
                     f"{int(ref['beat_valid'][t].sum())}; downbeats "
                     f"{int(got['downbeat_valid'][t].sum())} / {int(ref['downbeat_valid'][t].sum())}")

    def report_record_gates(self, specs, records) -> None:
        tempo = [self._tempo_hit(s, float(r.get("bpm", 0.0))) for s, r in zip(specs, records)]
        key = [r.get("key") == synth.key_name(s["key"]) for s, r in zip(specs, records)]
        self.log(f"gates: tempo {sum(tempo)}/{len(specs)}, key {sum(key)}/{len(specs)}")


def card_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def power_limit() -> str:
    import subprocess

    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False)
        return res.stdout.strip() or "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run_cell(root: Path, workload: str, seed: int, seconds: float, traced: bool,
             device, t_start: float, log=None, overrides=None) -> tuple:
    """Run one cell once. Returns ``(result, checks_lines)``: the result
    line's object and the lines that print each compared number beside its
    limit. ``overrides`` (``{"config": {...}, "mix": {...}}``) changes the
    cell's files for a test at a size the CPU holds."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    files = cell_files(load_manifest(root), workload)
    for part, values in (overrides or {}).items():
        getattr(files, part).update(values)
    driver = drivers.DRIVERS[files.mix["driver"]]()
    missing = {m["name"] for m in files.end_to_end} - set(driver.metrics) - {"setup_s"}
    if missing:
        raise CellError(f"{workload}: the {files.mix['driver']} driver does not measure "
                        f"{sorted(missing)}")
    run = Run(files, seed, device, log)
    try:
        if device.type == "cuda":
            log(f"card: {card_name(device)}; nvidia-smi name, power limit: {power_limit()}")
        driver.setup(run)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start
        log(f"set-up: {setup_s:.3f} s, of which {run.inputs_done - t_start:.3f} s to the "
            f"inputs made, {time.perf_counter() - run.inputs_done:.3f} s of warm-up")
        setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        run.port.reset_launch_counts()
        summary = None
        if traced:
            prof = trace_mod.profile()
            prof.start()
            with torch.profiler.record_function(trace_mod.WINDOW):
                win = driver.window(run, min(seconds, float(files.mix["trace_seconds"])))
            prof.stop()
        else:
            win = driver.window(run, seconds)
        window_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        launches = {fn.__name__: fn.launches for fn in run.port.KERNELS}
        log(f"window: {win['seconds']:.4f} s, {win['attempted']} tracks attempted, "
            f"kernel launches {launches}")
        found = banned_modules()
        if found:
            raise CellError(f"modules of JAX or the JAX package are loaded: {found}")
        result = {"correct": False, "attempted": win["attempted"], "failed": win["failed"]}
        metrics = {}
        if traced:
            summary = trace_mod.reduce(trace_mod.events(prof))
            del prof
            ctx = SimpleNamespace(run=run, driver=driver, window=win, summary=summary,
                                  peak_window_bytes=window_peak)
            for m in files.per_layer:
                value = load_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        else:
            values = dict(win["metrics"], setup_s=setup_s)
            for m in files.end_to_end:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = {"platform": "gpu" if device.type == "cuda" else device.type,
                            "kind": card_name(device), "count": 1,
                            "memory_peak_bytes": int(max(setup_peak, window_peak))}
        if summary is not None:
            result["device"]["busy_s"] = summary["busy_s"]
            result["device"]["window_s"] = summary["window_s"]
            result["breakdown"] = {"device_ops": trace_mod.top(summary["device_s_by_name"]),
                                   "idle_gaps": trace_mod.top(summary["idle_by_cause"])}
        win["outputs"] = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
        tally = driver.reference(run)
        log(f"widest gaps: {tally.widest()}")
        correct, checks = compare.judge(tally.numbers(), files.limits)
        result["correct"] = bool(correct and win["failed"] == 0)
        result["checks"] = checks
        lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
        return result, lines
    finally:
        run.close()
