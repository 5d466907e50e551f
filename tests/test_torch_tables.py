"""The port's one cache of constant tables (``stratum_dsp_tpu_torch/ops/
tables.py``) on the CPU: what it keys by and what it returns, and whole calls
of the pipeline made twice, which must come back bit-equal (no caller writes
into a shared table) with only data reads left in the second. Imports no
JAX."""

import numpy as np
import pytest
import torch

import stratum_dsp_tpu_torch as port
from stratum_dsp_tpu_torch import testing, tracing
from stratum_dsp_tpu_torch.ops import masked, tables

torch.set_num_threads(2)

# the points where the host waits for data, not for a table
DATA_READS = {"to_device", "silence.trim", "escalate.nonzero", "variation.any",
              "masked.valid_extent", "results", "timing.wait"}
# the default, and configurations whose key paths read other tables: the
# tuned exact peaks (the sort's band, the tuning residuals), a per-track
# chroma projection, the log-frequency projection and fold
CONFIGS = {
    "default": {},
    "tuned-exact": dict(enable_key_tuning_compensation=True, key_hpcp_approx_peaks=False),
    "tuned-chroma": dict(enable_key_tuning_compensation=True, enable_key_hpcp=False),
    "log-frequency": dict(enable_key_log_frequency=True, enable_key_hpcp=False),
}


def _reads() -> list:
    return [r["attrs"]["site"] for r in tracing.spans() if r["name"] == "host_read"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_calls_are_bit_equal_and_the_second_reads_only_data(name):
    cfg = port.AnalysisConfig(**CONFIGS[name])
    x = testing.kick_patterns([120.0, 172.0, 70.0], 8.0)  # two of three escalate
    lengths = [x.shape[1]] * 3
    first = port.analyze_batch(x, lengths, cfg, device="cpu")
    port.reset_launch_counts()
    with tracing.recording():
        second = port.analyze_batch(x, lengths, cfg, device="cpu")
    assert first.keys() == second.keys()
    for key in first:
        assert torch.equal(first[key], second[key]), key
    assert set(_reads()) <= DATA_READS
    assert tracing.counters()["host_reads"] == len(_reads()) > 0


def _pair(n: int):
    return np.arange(n, dtype=np.float32), {"n": n, "mask": np.arange(n) % 2 == 0}


def test_numpy_tables_are_copied_once_a_device_and_arguments():
    port.reset_launch_counts()
    with tracing.recording():
        arange, rest = tables.on("cpu", _pair, 5, site="test.pair")
        assert tables.on(None, _pair, 5, site="test.pair")[0] is arange
        assert tables.on("cpu", _pair, 6, site="test.pair")[0] is not arange
        assert tables.on("cpu", _pair, 5.0, site="test.pair")[0] is not arange  # typed
    assert _reads() == ["test.pair"] * 3
    assert torch.equal(arange, torch.arange(5, dtype=torch.float32))
    assert rest["n"] == 5 and rest["mask"].dtype == torch.bool


def _ramp(n: int, device):
    return torch.arange(n, device=device) * 2


def test_tables_made_on_the_device_are_only_cached():
    port.reset_launch_counts()
    ramp = tables.on("cpu", _ramp, 4)
    assert tables.on(torch.device("cpu"), _ramp, 4) is ramp
    assert torch.equal(ramp, torch.tensor([0, 2, 4, 6]))
    assert "host_reads" not in tracing.counters()


def test_rdiv_puts_its_scalar_on_the_device_without_a_copy():
    x = torch.tensor([3.0, 7.0, 0.1], dtype=torch.float32)
    port.reset_launch_counts()
    got = masked.rdiv(60.0, x)
    assert "host_reads" not in tracing.counters()
    assert torch.equal(got, torch.div(torch.tensor(60.0, dtype=torch.float32), x))
    assert got.dtype == torch.float32
