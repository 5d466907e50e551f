"""The loops that send a mix's tracks to the port, one a ``driver`` name.

Each driver has ``setup(run)``, which makes the inputs on the device from
the seed and warms every shape the window will use, ``window(run, seconds)``,
which sends work in a closed loop until ``seconds`` have passed and the last
answer is on the host, and ``reference(run)``, which holds every answer of
the window to the plain reference once the window has closed. ``run`` is the
harness's ``Run``: the cell's files, the seed, the device and the port.

* ``batch``: a ring of ``ring`` batches of the configuration's
  ``batch_size`` tracks, each ``[B, T]`` batch analysed by
  ``analyze_batch`` and its results copied to the host, one after another.
* ``single``: one client, one track a request (``B = 1``, ``T`` its own
  length), a pool of tracks of each length of ``lengths_s`` sent in an
  order drawn from the seed.
* ``files``: the configuration's ``batch_size`` tracks written as 16-bit
  mono WAVs, the batch CLI run in process over ``copies`` copies of the
  list, JSONL out; calls repeat until the window is over.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from . import compare, synth, traffic


def _to_host(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


def _batch_tensors(run, specs):
    t = int(round(max(s["seconds"] for s in specs) * run.sample_rate))
    samples = synth.tracks(specs, t, run.device, run.sample_rate)
    lengths = torch.as_tensor([int(round(s["seconds"] * run.sample_rate)) for s in specs],
                              dtype=torch.int64, device=run.device)
    return samples, lengths


def _analyze(run, samples, lengths) -> dict:
    return run.port.analyze_batch(samples, lengths, run.port_cfg, run.sample_rate,
                                  run.port_caps, device=run.device)


class BatchDriver:
    """A ring of batches, analysed one after another, closed loop."""

    metrics = ("tracks_per_s",)

    def setup(self, run):
        n = int(run.config["batch_size"])
        self.ring = []
        for _ in range(int(run.mix.get("ring", 1))):
            specs = traffic.draw_specs(run.mix, n, run.rng)
            self.ring.append((specs, *_batch_tensors(run, specs)))
        run.setup_done_inputs()
        for _, samples, lengths in self.ring:
            _to_host(_analyze(run, samples, lengths))

    def window(self, run, seconds):
        answers = []
        t0 = time.perf_counter()
        while True:
            i = len(answers) % len(self.ring)
            _, samples, lengths = self.ring[i]
            with torch.profiler.record_function("portbench.analyze_batch"):
                out = _analyze(run, samples, lengths)
            with torch.profiler.record_function("portbench.results_to_host"):
                answers.append((i, _to_host(out)))
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.answers = answers
        tracks = sum(a[1]["ok"].shape[0] for a in answers)
        return {"seconds": wall, "attempted": tracks, "failed": 0,
                "outputs": [a[1] for a in answers],
                "metrics": {"tracks_per_s": tracks / wall}}

    def once(self, run, answer):
        """Every batch of the ring answered once by ``answer(samples, lengths)``."""
        self.answers = [(i, answer(s, n)) for i, (_, s, n) in enumerate(self.ring)]

    def reference(self, run) -> compare.Tally:
        tally = compare.Tally()
        for i, (specs, samples, lengths) in enumerate(self.ring):
            got = [a for j, a in self.answers if j == i]
            if not got:
                continue
            ref = run.reference_outputs(samples, lengths)
            where = set()
            for a in got:
                compare.add_batch(tally, a, ref, where)
            run.report_gates(specs, got[0])
            run.report_differences(i, where, got[0], ref)
        return tally


class SingleDriver:
    """One client, one track a request."""

    metrics = ("track_latency_p50_ms", "track_latency_p90_ms")

    def setup(self, run):
        specs = traffic.draw_specs(run.mix, 0, run.rng)
        self.pool = [(s, *_batch_tensors(run, [s])) for s in specs]
        self.order = run.rng.permutation(len(self.pool))
        run.setup_done_inputs()
        warmed = set()
        for s, samples, lengths in self.pool:
            if s["seconds"] not in warmed:
                warmed.add(s["seconds"])
                _to_host(_analyze(run, samples, lengths))

    def window(self, run, seconds):
        answers, latencies = [], []
        t0 = time.perf_counter()
        while True:
            i = int(self.order[len(answers) % len(self.order)])
            _, samples, lengths = self.pool[i]
            r0 = time.perf_counter()
            with torch.profiler.record_function("portbench.request"):
                host = _to_host(_analyze(run, samples, lengths))
            latencies.append(time.perf_counter() - r0)
            answers.append((i, host))
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.answers = answers
        lat_ms = np.asarray(latencies) * 1e3
        return {"seconds": wall, "attempted": len(answers), "failed": 0,
                "outputs": [a[1] for a in answers],
                "metrics": {"track_latency_p50_ms": float(np.percentile(lat_ms, 50)),
                            "track_latency_p90_ms": float(np.percentile(lat_ms, 90))}}

    def once(self, run, answer):
        """Every track of the pool answered once by ``answer(samples, lengths)``."""
        self.answers = [(i, answer(s, n)) for i, (_, s, n) in enumerate(self.pool)]

    def reference(self, run) -> compare.Tally:
        tally = compare.Tally()
        for i in sorted({j for j, _ in self.answers}):
            s, samples, lengths = self.pool[i]
            ref = run.reference_outputs(samples, lengths)
            got = [a for j, a in self.answers if j == i]
            where = set()
            for a in got:
                compare.add_batch(tally, a, ref, where)
            run.report_gates([s], got[0])
            run.report_differences(i, where, got[0], ref)
        return tally


def cli_flags(config: dict) -> list:
    """``AnalysisConfig`` overrides as the batch CLI's flags."""
    flags = []
    for k, v in config.get("analysis_config", {}).items():
        if isinstance(v, bool):
            v = "true" if v else "false"
        elif isinstance(v, (list, tuple)):
            v = ",".join(map(str, v))
        flags += ["--" + k.replace("_", "-"), str(v)]
    caps = config.get("pipeline_caps", {})
    for k in ("max_onsets", "max_beats"):
        if k in caps:
            flags += ["--" + k.replace("_", "-"), str(caps[k])]
    return flags


def write_wavs(batch: torch.Tensor, lengths, directory: Path) -> list:
    """``batch [B, T]`` float32 as 16-bit mono WAVs ``track_00.wav`` ...
    under ``directory`` (a frozen copy of ``write_wavs`` in
    ``stratum_dsp_tpu_torch/measure.py`` at 83ec59a: values clamped to
    [-1, 1], times 32767, truncated)."""
    import wave

    x16 = (batch.clamp(-1.0, 1.0) * 32767.0).to(torch.int16).cpu().numpy()
    paths = []
    for i, row in enumerate(x16):
        paths.append(str(directory / f"track_{i:02d}.wav"))
        with wave.open(paths[-1], "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(synth.SAMPLE_RATE)
            w.writeframes(row[:int(lengths[i])].astype("<i2").tobytes())
    return paths


class FilesDriver:
    """The batch CLI over WAV files, in process."""

    metrics = ("file_tracks_per_s",)

    def setup(self, run):
        n = int(run.config["batch_size"])
        self.specs = traffic.draw_specs(run.mix, n, run.rng)
        samples, lengths = _batch_tensors(run, self.specs)
        self.dir = run.scratch_dir()
        self.paths = write_wavs(samples, lengths.cpu().numpy(), self.dir)
        del samples
        run.setup_done_inputs()
        self.argv_tail = ["--batch-size", str(n), "--device", str(run.device),
                          *cli_flags(run.config)]
        self._call(run, self.paths, self.dir / "warm.jsonl")

    def _call(self, run, paths, out: Path):
        from stratum_dsp_tpu_torch.cli.analyze_batch import main

        rc = main([*paths, "-o", str(out), *self.argv_tail])
        if rc != 0:
            raise RuntimeError(f"the batch CLI returned {rc}")

    def window(self, run, seconds):
        paths = self.paths * int(run.mix["copies"])
        self.outs = []
        t0 = time.perf_counter()
        while True:
            self.outs.append(self.dir / f"call_{len(self.outs)}.jsonl")
            with torch.profiler.record_function("portbench.cli_call"):
                self._call(run, paths, self.outs[-1])
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.records = []
        for p in self.outs:
            with open(p) as fh:
                self.records.append([json.loads(line) for line in fh if line.strip()])
        written = sum(1 for recs in self.records for r in recs if "error" not in r)
        failed = sum(1 for recs in self.records for r in recs if "error" in r)
        return {"seconds": wall, "attempted": len(paths) * len(self.outs), "failed": failed,
                "outputs": [], "metrics": {"file_tracks_per_s": written / wall}}

    def once(self, run, answer):
        """The files answered once: by one call of the CLI as the window makes
        it, or, with ``answer`` (``run.reference_outputs``'s signature), by
        the reference's records under that arithmetic."""
        if answer is None:
            out = self.dir / "once.jsonl"
            self._call(run, self.paths * int(run.mix["copies"]), out)
            with open(out) as fh:
                self.records = [[json.loads(line) for line in fh if line.strip()]]
        else:
            from . import reference

            recs = reference.file_records(self.paths, run.config, run.sample_rate, run.device,
                                          answer=answer)
            self.records = [[{"file": p, **recs[p]} for p in self.paths] * int(run.mix["copies"])]

    def reference(self, run):
        from . import reference

        refs = reference.file_records(self.paths, run.config, run.sample_rate, run.device)
        tally = compare.Tally()
        expected = self.paths * int(run.mix["copies"])
        for recs in self.records:
            by_file = {}
            for r in recs:
                by_file.setdefault(r.get("file"), []).append(r)
            for p in expected:
                got = by_file.get(p, [])
                compare.add_record(tally, got.pop(0) if got else None, refs[p])
        first = {r.get("file"): r for r in reversed(self.records[0])}
        run.report_record_gates(self.specs, [first.get(p, {}) for p in self.paths])
        return tally


DRIVERS = {"batch": BatchDriver, "single": SingleDriver, "files": FilesDriver}

