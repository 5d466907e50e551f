"""What a run and the reference load: no JAX, nothing of the JAX package,
and the reference nothing of the port. Each check runs in a fresh process."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "stratum_dsp_tpu"}

RUN_TINY_CELL = """
import json, sys, time
sys.path.insert(0, {root!r})
from pathlib import Path
from portbench import harness
res, _ = harness.run_cell(Path({root!r}), "default.adversarial", 7, 0.1, False, "cpu",
                          time.perf_counter(), log=lambda m: None,
                          overrides={{"config": {{"batch_size": 2}}, "mix": {{"track_seconds": 5.0}}}})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from portbench import reference, synth
x = synth.tracks([{{"bpm": 120.0, "key": 0, "offset_s": 0.0, "seconds": 4.0}}], 4 * 44100, "cpu")
reference.analyze(x, torch.tensor([4 * 44100]), {{}}, 44100)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], cwd=ROOT,
                         capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = loaded(RUN_TINY_CELL)
    assert "stratum_dsp_tpu_torch" in names and "portbench" in names
    assert not names & BANNED


def test_the_reference_loads_nothing_of_the_port():
    names = loaded(REFERENCE_ONLY)
    assert not names & (BANNED | {"stratum_dsp_tpu_torch"})


def test_no_source_under_portbench_imports_jax_or_the_jax_package():
    import ast

    for path in (ROOT / "portbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & BANNED, (path, tops)
            if "reference" in path.parts:
                assert "stratum_dsp_tpu_torch" not in tops, (path, tops)


def test_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "default.adversarial",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600, env={"CUDA_VISIBLE_DEVICES": "",
                                                                          "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
