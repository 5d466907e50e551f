"""The frozen roofline arithmetic equals the port's ``bound_ms`` at the main
path's shapes when each launch is one chunk of whole tracks."""

import pytest

from portbench import roofline
from portbench.reference.plain.config import AnalysisConfig
from portbench.reference.plain.features.period.novelty import novelty_tables


@pytest.mark.parametrize("variant", [dict(emit_stride2=True, emit_onset=True, use_mel=True),
                                     dict(emit_stride2=False, emit_onset=False, use_mel=True)])
@pytest.mark.parametrize("b,c", [(40, 256), (12, 256)])
def test_novelty_work_is_bound_ms(variant, b, c):
    from stratum_dsp_tpu_torch.ops import novelty

    tables = novelty_tables(AnalysisConfig(), 44100, 2048)
    n_pack = tables.mel_packed[1].size
    want = novelty.bound_ms(b, c, tables.n_bins, tables.nb, tables.nm, n_pack, tables.sf_k,
                            **variant)
    n_bytes, n_ops = roofline.novelty_work([c] * b, tables.n_bins, n_pack, tables.sf_k,
                                           **variant)
    assert (n_bytes, n_ops) == (want["bytes"], want["operations"])
    assert 1e3 * roofline.least_seconds(n_bytes, n_ops) == pytest.approx(want["bound_ms"])


@pytest.mark.parametrize("b,ext,keep", [(40, 216, 931), (40, 216, 4097)])
def test_polyphase_work_is_bound_ms(b, ext, keep):
    from stratum_dsp_tpu_torch.ops import polyphase

    want = polyphase.bound_ms(b, 256, 1024, 16, ext, keep)
    n_bytes, n_ops = roofline.polyphase_work([ext] * b, 16, keep)
    assert (n_bytes, n_ops) == (want["bytes"], want["operations"])
    assert 1e3 * roofline.least_seconds(n_bytes, n_ops) == pytest.approx(want["bound_ms"])


def test_peaks_are_the_ports():
    from stratum_dsp_tpu_torch.ops import cuda_build

    assert roofline.H100_BYTES_PER_S == cuda_build.H100_BYTES_PER_S
    assert roofline.H100_F32_OPS_PER_S == cuda_build.H100_F32_OPS_PER_S
