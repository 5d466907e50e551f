"""The port runs where JAX cannot be imported (the card's machine has none),
under ``SLICE_CONFIG`` and under the default ``AnalysisConfig``."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
import stratum_dsp_tpu_torch as port
from stratum_dsp_tpu_torch import testing
caps = port.PipelineCaps(max_onsets=256, max_beats=256, seg_beat_cap=32, max_segments=12)
x = testing.kick_patterns([120.0], 6.0)
out = port.analyze_batch(x, torch.tensor([x.shape[1]]), port.SLICE_CONFIG, 44100, caps)
assert bool(out["ok"][0]) and abs(float(out["bpm"][0]) - 120.0) < 2.0, out["bpm"]
# the default AnalysisConfig, with a trap-zone track that escalates
x = testing.kick_patterns([120.0, 172.0], 6.0)
out = port.analyze_batch(x, torch.tensor([x.shape[1]] * 2), caps=caps)
assert bool(out["multi_res_triggered"][1]), out["multi_res_triggered"]
assert abs(float(out["bpm"][0]) - 120.0) < 2.0, out["bpm"]
assert sys.modules["jax"] is None
print("bpm", float(out["bpm"][0]))
"""


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT.format(repo=str(REPO))],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("bpm ")


def test_no_jax_import_in_port_sources():
    """No module of the port, nor chip_smoke.py, imports jax."""
    files = sorted((REPO / "stratum_dsp_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), (path, line)
