"""The HPCP of the bisection peak pick (``ops/hpcp.py:hpcp_bisect``, the CUDA
kernel ``csrc/hpcp_bisect.cu`` and its plain version).

On the CPU: the host-side band against the peak mask it replaces,
``frames_to_hpcp`` bit-equal to the benchmark's frozen copy of the port
before the kernel (``portbench/reference``), the per-device table cache, the
kernel's refusals, and the readers of the HPCP layer's metrics. On the card
(``cuda`` marker; they skip without one): the kernel against the plain
version within 1e-6 on random rows, ties at the K-th peak, rows with fewer
peaks than K, zero rows, whitened rows, per-track matrices, the bass band and
bf16 rows, and its launches and ``hpcp_kernel`` counts a key STFT chunk.
Imports no JAX, so that the ``cuda`` tests run on the card with the conftest
left out: ``python3 -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_hpcp_kernel.py``."""

import numpy as np
import pytest
import torch

import stratum_dsp_tpu_torch as port
from portbench import harness
from portbench.reference.plain.features.chroma import extractor as plain_chx
from stratum_dsp_tpu_torch import testing, tracing
from stratum_dsp_tpu_torch.features.chroma import extractor as chx
from stratum_dsp_tpu_torch.features.key import pipeline as key_pipeline
from stratum_dsp_tpu_torch.ops import hpcp

torch.set_num_threads(2)

SR, FFT, KEEP = 44100, 8192, 931  # the key STFT and the bins it keeps
HPCP_ARGS = (SR, FFT, 0.5)  # sample rate, FFT size, sigma
HPCP_REST = (24, 4, 0.6, 0.5)  # peaks, harmonics, decay, magnitude power


def _static_ok(n_bins, hi_bin, sample_rate, fft_size, fmin, fmax):
    """The peak band as ``frames_to_hpcp`` built it before the kernel: a mask
    over the first ``hi_bin`` bins."""
    freqs = np.arange(n_bins) * (sample_rate / fft_size)
    k = np.arange(hi_bin)
    return (k >= 1) & (k < n_bins - 1) & (freqs[:hi_bin] >= fmin) & (freqs[:hi_bin] <= fmax)


@pytest.mark.parametrize("n_bins,sample_rate,fft_size,fmin,fmax", [
    (KEEP, SR, FFT, 100.0, 5000.0),  # the default band
    (KEEP, SR, FFT, 55.0, 300.0),  # the bass blend's
    (KEEP, SR, FFT, 20.0, 5000.0),  # fmin at or below a bin: the band starts at bin 1
    (4097, SR, FFT, 5.0, 8000.0),
    (1025, SR, 2048, 100.0, 22050.0),  # hi_bin == n_bins: the last bin is no interior
    (4097, 48000, FFT, 100.0, 5000.0),
    (2049, 22050, 4096, 43.06640625, 5000.0),  # fmin on a bin's frequency
    (KEEP, SR, FFT, 4000.0, 4001.0),  # no bin in the band
])
def test_peak_band_is_the_run_of_the_static_mask(n_bins, sample_rate, fft_size, fmin, fmax):
    hi_bin = min(int(np.ceil(fmax / (sample_rate / fft_size))) + 2, n_bins)
    ok = _static_ok(n_bins, hi_bin, sample_rate, fft_size, fmin, fmax)
    k_lo, k_hi = hpcp.peak_band(n_bins, hi_bin, sample_rate, fft_size, fmin, fmax)
    assert 0 <= k_lo <= k_hi <= hi_bin
    want = np.zeros(hi_bin, bool)
    want[k_lo:k_hi] = True
    np.testing.assert_array_equal(ok, want)


def _spectra(dtype=torch.float32, seed=16):
    """``[3, 8, KEEP]`` magnitudes: random rows (~310 peaks), rows of four
    values (ties at the K-th peak), a zero row, rows with fewer peaks than
    K, and a row of negative values."""
    rng = np.random.default_rng(seed)
    x = rng.random((3, 8, KEEP)).astype(np.float32) * 3.0
    x[1] = rng.integers(0, 4, (8, KEEP)).astype(np.float32)
    x[2, 0] = 0.0
    x[2, 1:4] = 1.0
    x[2, 1:4, 100::100] = 2.0
    x[2, 4] = -x[2, 4]
    return torch.as_tensor(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("whiten", [False, True], ids=["plain", "whitened"])
@pytest.mark.parametrize("tuning", ["scalar", "per-track"])
def test_cpu_bisection_equals_the_port_before_the_kernel(dtype, whiten, tuning):
    spec = _spectra(dtype)
    t = torch.as_tensor([0.1, -0.2, 0.3]) if tuning == "per-track" else 0.05
    got = chx.frames_to_hpcp(spec, *HPCP_ARGS, t, *HPCP_REST, whiten)
    want = plain_chx.frames_to_hpcp(spec, *HPCP_ARGS, t, *HPCP_REST, whiten)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert not got[2, 0].any() and got[0].any()


@pytest.mark.parametrize("whiten", [False, True], ids=["plain", "whitened"])
def test_cpu_bass_band_equals_the_port_before_the_kernel(whiten):
    spec = _spectra()
    kw = dict(fmin_hz=55.0, fmax_hz=300.0)
    got = chx.frames_to_hpcp(spec, *HPCP_ARGS, 0.0, 12, 4, 0.6, 0.5, whiten, **kw)
    want = plain_chx.frames_to_hpcp(spec, *HPCP_ARGS, 0.0, 12, 4, 0.6, 0.5, whiten, **kw)
    assert torch.equal(got, want)


def test_cpu_other_power_equals_the_port_before_the_kernel():
    spec = _spectra()
    got = chx.frames_to_hpcp(spec, *HPCP_ARGS, 0.0, 24, 4, 0.6, 0.7)
    want = plain_chx.frames_to_hpcp(spec, *HPCP_ARGS, 0.0, 24, 4, 0.6, 0.7)
    assert torch.equal(got, want)


def test_the_table_cache_builds_once_a_device_and_parameters():
    params = (SR, FFT, KEEP, 0.4375, 0.0, 4, 0.6, 100.0, 5000.0)  # a sigma of its own
    port.reset_launch_counts()
    first = chx.hpcp_harmonic_matrix_on("cpu", *params)
    assert tracing.counters().get("host_reads") == 1
    assert chx.hpcp_harmonic_matrix_on(torch.device("cpu"), *params) is first
    assert tracing.counters().get("host_reads") == 1
    np.testing.assert_array_equal(first.numpy(), chx.hpcp_harmonic_matrix(*params))


def test_the_bisection_waits_for_no_upload_a_chunk():
    """The band is two ints and the table is cached: of the sites the HPCP
    read from before, only the sort's band is left."""
    spec = _spectra()
    chx.frames_to_hpcp(spec, *HPCP_ARGS, 0.0, *HPCP_REST)  # the table's first copy
    port.reset_launch_counts()
    with tracing.recording():
        for _ in range(3):
            chx.frames_to_hpcp(spec, *HPCP_ARGS, 0.0, *HPCP_REST)
        chx.frames_to_hpcp(spec, *HPCP_ARGS, 0.0, *HPCP_REST, approx_peaks=False)
    sites = [r["attrs"]["site"] for r in tracing.spans() if r["name"] == "host_read"]
    assert sites == ["chroma.peak_band"]
    assert hpcp.hpcp_bisect.launches == 0 and "hpcp_kernel" not in tracing.counters()


def test_the_wrapper_refuses_other_devices():
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hpcp.hpcp_bisect(x, x, (1, 7), 2, 0.5, torch.zeros((8, 12), device="meta"))


def test_the_bound_counts_the_rows_once():
    b = hpcp.hpcp_bisect_bound_ms(40 * 183, KEEP, 24)
    assert b["bytes"] == 40 * 183 * (KEEP * 4 + 48) + KEEP * 48
    assert b["bound_by"] == "bytes" and 0.007 < b["bound_ms"] < 0.009


def _span(sid, name, exact=None, counts=None, stream_ms=1.0, call=1, tracks=None):
    attrs = {} if exact is None else {"exact": exact}
    if tracks is not None:
        attrs["tracks"] = tracks
    return {"id": sid, "name": name, "parent": None, "call": call, "thread": 1,
            "start_ns": sid, "end_ns": sid + 1, "host_ms": 1.0, "stream_ms": stream_ms,
            "counts": counts or {}, "attrs": attrs}


@pytest.mark.parametrize("kernel", [True, False], ids=["change", "parent"])
def test_the_hpcp_layers_readers(monkeypatch, kernel):
    """Hand-made spans of two calls of 40 tracks: three bisection chunks and
    one sorted, each chunk's count on its span where the kernel ran."""
    counts = {"hpcp_kernel": 1} if kernel else {}
    recs = [_span(1, "analyze", tracks=40), _span(2, "key.hpcp", False, counts, 0.5),
            _span(3, "key.hpcp", False, counts, 0.25), _span(4, "key.hpcp", True, {}, 9.0),
            _span(5, "analyze", tracks=40, call=2),
            _span(6, "key.hpcp", False, counts, 0.25, call=2)]
    monkeypatch.setattr(tracing, "spans", lambda: [dict(r) for r in recs])
    assert harness.load_reader("key_hpcp_ms_per_track.approx")(None) == pytest.approx(1.0 / 80)
    assert harness.load_reader("key_hpcp_ms_per_track.exact")(None) == pytest.approx(9.0 / 80)
    assert harness.load_reader("hpcp_kernel_share")(None) == (1.0 if kernel else 0.0)
    monkeypatch.setattr(tracing, "spans", lambda: [dict(r, stream_ms=None) for r in recs])
    assert harness.load_reader("key_hpcp_ms_per_track.approx")(None) is None
    monkeypatch.setattr(tracing, "spans", lambda: [r for r in recs if r["attrs"].get("exact")
                                                   is not False])
    assert harness.load_reader("key_hpcp_ms_per_track.approx")(None) is None
    assert harness.load_reader("hpcp_kernel_share")(None) is None


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda:0")


def _case(dev, shape=(40, 183, KEEP), fmin=100.0, fmax=5000.0, k_top=24, dtype=torch.float32,
          whiten=False, per_track=False, ties=False, seed=0):
    """The kernel's and the plain version's HPCP of one set of rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = torch.rand(shape, generator=gen, device=dev) * 3.0
    if ties:
        spec = torch.randint(0, 4, shape, generator=gen, device=dev).float()
    spec[0, :3] = 0.0  # rows with no peak
    spec[-1, -3:] = 1.0  # rows with fewer peaks than K
    spec[-1, -3:, 100::100] = 2.0
    spec = spec.to(dtype)
    n = shape[-1]
    hi_bin = min(int(np.ceil(fmax / (SR / FFT))) + 2, n)
    sel = chx.spectral_whiten(spec[..., :hi_bin], 31) if whiten else spec[..., :hi_bin]
    if per_track:
        tun = torch.rand((shape[0],), generator=gen, device=dev) - 0.5
        mat = chx.hpcp_harmonic_matrix_dynamic(SR, FFT, hi_bin, 0.5, tun, 4, 0.6, fmin, fmax)
    else:
        mat = chx.hpcp_harmonic_matrix_on(dev, SR, FFT, hi_bin, 0.5, 0.0, 4, 0.6, fmin, fmax)
    band = hpcp.peak_band(n, hi_bin, SR, FFT, fmin, fmax)
    args = (spec[..., :hi_bin], sel, band, k_top, 0.5, mat)
    before = hpcp.hpcp_bisect.launches
    got = hpcp.hpcp_bisect(*args)
    torch.cuda.synchronize()
    assert hpcp.hpcp_bisect.launches == before + 1
    return got, hpcp.hpcp_bisect_plain(*args)


CASES = {
    "random": {}, "ties": dict(ties=True), "whitened": dict(whiten=True),
    "per-track": dict(per_track=True), "bass band": dict(fmin=55.0, fmax=300.0, k_top=12),
    "bf16": dict(dtype=torch.bfloat16), "bf16 ties": dict(dtype=torch.bfloat16, ties=True),
    "whitened bf16": dict(whiten=True, dtype=torch.bfloat16),
    "single request": dict(shape=(1, 512, KEEP)),
    "band past 2048 bins": dict(shape=(4, 16, 4097), fmax=20000.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_the_card(dev, case):
    """Within 1e-6: L2-normalised values are at most 1, and only the order
    of the 12 sums differs; another peak set would miss by far more."""
    got, want = _case(dev, **CASES[case])
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert not got[0, :3].any() and got[0, 3:].any()


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(dev):
    x = torch.rand((2, 3, 64), device=dev)
    mat = torch.zeros((64, 12), device=dev)
    with pytest.raises(ValueError, match="f32 or bf16"):
        hpcp.hpcp_bisect(x.half(), x.half(), (1, 63), 4, 0.5, mat)
    with pytest.raises(ValueError, match="matrix"):
        hpcp.hpcp_bisect(x, x, (1, 63), 4, 0.5, mat.double())
    with pytest.raises(ValueError, match="do not match"):
        hpcp.hpcp_bisect(x, x, (1, 63), 4, 0.5, torch.zeros((3, 64, 12), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("name,overrides,per_chunk", [
    ("default", {}, 1), ("bass blend", dict(enable_key_hpcp_bass_blend=True), 2),
    ("per-track tuning", dict(enable_key_tuning_compensation=True), 1),
    ("exact peaks", dict(key_hpcp_approx_peaks=False), 0)])
def test_launches_and_counts_a_key_chunk(dev, monkeypatch, name, overrides, per_chunk):
    """The kernel launches once a key STFT chunk (twice under the bass
    blend, never under exact peaks), each launch counted on its ``key.hpcp``
    span; the key features equal those of the plain version on the card
    within 1e-6."""
    x = testing.c_major_scale().repeat(2)[None].repeat(2, 1).to(dev)
    n = torch.full((2,), x.shape[1], dtype=torch.int64, device=dev)
    cfg = port.AnalysisConfig().replace(**overrides)
    tuning = torch.tensor([0.02, -0.03], device=dev) if "tuning" in name else 0.0
    port.reset_launch_counts()
    with tracing.recording():
        got = key_pipeline.extract_key_features(x, n, cfg, SR, tuning, chunk_frames=128)
        torch.cuda.synchronize()
    chunks = tracing.counters()["key_stft_chunks"]
    assert chunks >= 4
    assert hpcp.hpcp_bisect.launches == tracing.counters().get("hpcp_kernel", 0) \
        == per_chunk * chunks
    spans = [r for r in tracing.spans() if r["name"] == "key.hpcp"]
    assert len(spans) == max(per_chunk, 1) * chunks
    assert all(r["counts"].get("hpcp_kernel", 0) == min(per_chunk, 1) for r in spans)
    monkeypatch.setattr(hpcp, "hpcp_bisect", hpcp.hpcp_bisect_plain)
    want = key_pipeline.extract_key_features(x, n, cfg, SR, tuning, chunk_frames=128)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
