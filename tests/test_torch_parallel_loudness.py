"""LOUDNESS normalization on the port's (tracks, time) mesh, block by block,
against the JAX package's 2-D mesh on the CPU: silence-sandwich tracks whose
leading silence lies inside a block, crosses a block edge, or is short. JAX
runs on the 8 virtual CPU devices of ``tests/conftest.py``; the port's mesh
repeats ``torch.device("cpu")`` and takes the batch as numpy.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from stratum_dsp_tpu.analysis.pipeline import PipelineCaps as JaxCaps
from stratum_dsp_tpu.config import AnalysisConfig as JaxConfig
from stratum_dsp_tpu.config import NormalizationMethod as JaxNorm
from stratum_dsp_tpu.parallel import mesh as jmesh

import stratum_dsp_tpu_torch as port
from stratum_dsp_tpu_torch import testing
from stratum_dsp_tpu_torch.parallel import mesh as pmesh

SR = 44100
CAPS = dict(max_onsets=256, max_beats=256, seg_beat_cap=16, max_segments=6)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def sandwich(lead_s: float, body: np.ndarray, tail_s: float) -> np.ndarray:
    """``lead_s`` of silence, ``body``, ``tail_s`` of silence."""
    return np.concatenate([np.zeros(int(lead_s * SR), np.float32), np.asarray(body, np.float32),
                           np.zeros(int(tail_s * SR), np.float32)])


def test_loudness_on_a_2d_mesh_matches_jax():
    """The default config with LOUDNESS on a (4, 2) mesh: every output the
    JAX package's 2-D mesh gives (``testing.assert_outputs_match``),
    discrete outputs exactly; the steady tone's BPM confidences are rounding
    noise, held to the contract's NOISE_FLOOR_TOL as every port test holds
    that track. Blocks are ~3 s: the second track's 3.5 s of
    leading silence crosses the block edge, so its trim shift copies pieces
    of both blocks."""
    tracks = [sandwich(1.0, testing.kick_pattern(120.0, 3.0), 1.0),
              sandwich(3.5, testing.kick_pattern(96.0, 2.5), 0.5),
              np.asarray(testing.silence_sandwich(2.0, 2.0)),
              sandwich(0.5, testing.kick_pattern(140.0, 4.0), 1.5)]
    samples, lengths = testing.pad_batch([torch.as_tensor(t) for t in tracks])
    samples, lengths = samples.numpy(), lengths.numpy()

    jcfg = JaxConfig(normalization=JaxNorm.LOUDNESS)
    jm = jmesh.make_mesh(jax.devices()[:8], n_time=2)
    padded = jmesh.pad_batch_for_mesh(samples, jm)
    want = jmesh.analyze_batch_sharded(padded, lengths.astype(np.int32), jcfg, SR,
                                       JaxCaps(**CAPS), jm)
    want = {k: np.asarray(v) for k, v in want.items()}

    pcfg = port.AnalysisConfig.from_dict(dataclasses.asdict(jcfg))
    pm = pmesh.make_mesh([torch.device("cpu")] * 8, n_time=2)
    assert np.array_equal(pmesh.pad_batch_for_mesh(samples, pm), padded)
    got = pmesh.analyze_batch_sharded(padded, lengths, pcfg, SR, port.PipelineCaps(**CAPS), pm)
    testing.assert_outputs_match(want, got, noise_floor_track=2)
    t_blk = padded.shape[1] // 2
    trim = got["trim_start_seconds"].numpy()
    assert trim[1] * SR > t_blk > trim[0] * SR, (trim, t_blk)
    assert bool(got["ok"].all()), got["ok"]
