"""The port runs where neither JAX nor the JAX package can be imported (the
card's machine has no JAX), under ``SLICE_CONFIG`` and under the default
``AnalysisConfig``; and it runs on the card unless asked for the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["stratum_dsp_tpu"] = None  # and so does any import of the JAX package
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
import stratum_dsp_tpu_torch as port
from stratum_dsp_tpu_torch import testing
caps = port.PipelineCaps(max_onsets=256, max_beats=256, seg_beat_cap=32, max_segments=12)
x = testing.kick_patterns([120.0], 6.0)
out = port.analyze_batch(x, torch.tensor([x.shape[1]]), port.SLICE_CONFIG, 44100, caps,
                         device="cpu")
assert bool(out["ok"][0]) and abs(float(out["bpm"][0]) - 120.0) < 2.0, out["bpm"]
# the default AnalysisConfig, with a trap-zone track that escalates
x = testing.kick_patterns([120.0, 172.0], 6.0)
out = port.analyze_batch(x, torch.tensor([x.shape[1]] * 2), caps=caps, device="cpu")
assert bool(out["multi_res_triggered"][1]), out["multi_res_triggered"]
assert abs(float(out["bpm"][0]) - 120.0) < 2.0, out["bpm"]
assert sys.modules["jax"] is None and sys.modules["stratum_dsp_tpu"] is None
print("bpm", float(out["bpm"][0]))
"""


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT.format(repo=str(REPO))],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("bpm ")


FORBIDDEN_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|stratum_dsp_tpu)(\.|\s|$)")


def test_no_jax_import_in_port_sources():
    """No module of the port, nor chip_smoke.py, nor the port's bench script
    imports jax or anything of the JAX package (``stratum_dsp_tpu_torch`` is
    the port itself)."""
    files = sorted((REPO / "stratum_dsp_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "scripts" / "torch_port_bench.py"]
    assert len(files) > 20
    for path in files:
        for line in path.read_text().splitlines():
            assert not FORBIDDEN_IMPORT.match(line), (path, line)
    for line in ("import jax", "from jax import numpy", "import jax.numpy as jnp",
                 "import stratum_dsp_tpu", "    from stratum_dsp_tpu.config import AnalysisConfig"):
        assert FORBIDDEN_IMPORT.match(line), line
    for line in ("import stratum_dsp_tpu_torch as port", "import jaxtyping",
                 "from stratum_dsp_tpu_torch import testing"):
        assert not FORBIDDEN_IMPORT.match(line), line


def _tiny_batch():
    import stratum_dsp_tpu_torch as port
    from stratum_dsp_tpu_torch import testing

    x = testing.kick_patterns([120.0], 3.0).numpy()
    caps = port.PipelineCaps(max_onsets=128, max_beats=64, seg_beat_cap=16, max_segments=4)
    return port, x, np.asarray([x.shape[1]]), caps


def test_default_device_is_the_card_and_raises_without_one():
    """``analyze_batch`` without ``device`` never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    port, x, lengths, caps = _tiny_batch()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.analyze_batch(x, lengths, port.SLICE_CONFIG, caps=caps)


def test_cpu_runs_when_asked_for():
    port, x, lengths, caps = _tiny_batch()
    out = port.analyze_batch(x, lengths, port.SLICE_CONFIG, caps=caps, device="cpu")
    assert out["bpm"].device.type == "cpu" and bool(out["ok"][0])
