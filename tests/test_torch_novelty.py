"""The port's fused BPM novelty reducer (``stratum_dsp_tpu_torch/ops/novelty.py``
and ``features/period/novelty.py``) against the JAX package.

On the CPU the wrapper runs its plain PyTorch version. It is held, output key
by output key, to the Pallas kernel in interpret mode (the JAX reducer under
``STRATUM_FORCE_PALLAS_NOVELTY``) and to the JAX XLA reducer at the bound
the JAX package holds its own kernel to (``tests/test_pallas_kernels.py``):
max |d| / max |ref| < 1e-5, summation order being the only difference; the
carry is exact. The CUDA kernel is compared with the plain version on the
card (``cuda`` marker).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stratum_dsp_tpu.config import AnalysisConfig
from stratum_dsp_tpu.features.period import novelty as jnov
from stratum_dsp_tpu.ops import novelty_pallas
from stratum_dsp_tpu_torch.features.period import novelty as pnov
from stratum_dsp_tpu_torch.ops import novelty as pops

torch.set_num_threads(2)

CFG = AnalysisConfig()
SR = 44100
VARIANTS = [(True, True), (False, False)]  # base pass, auxiliary hop-256 pass
IDS = ["base", "aux"]
REL_TOL = 1e-5


def _inputs(rng, b=2, c=260):
    """The inputs of tests/test_pallas_kernels.py: c is not a tile multiple."""
    n_bins = CFG.frame_size // 2 + 1
    spec = rng.random((b, c, n_bins)).astype(np.float32) * 3.0
    carry = rng.random((b, 2, n_bins)).astype(np.float32)
    return spec, carry


def _jax_reducer(emit_stride2, emit_onset, monkeypatch=None, captured=None):
    """The JAX reducer; with ``monkeypatch`` its Pallas kernel in interpret
    mode, recording the tables the JAX package builds into ``captured``."""
    if monkeypatch is not None:
        original = novelty_pallas.fused_novelty_features

        def recording(spec, prev2, sf_mask, ew, mel_w, **kw):
            captured.update(sf_mask=sf_mask, ew=ew, mel_w=mel_w, **kw)
            return original(spec, prev2, sf_mask, ew, mel_w, **dict(kw, interpret=True))

        monkeypatch.setattr(novelty_pallas, "fused_novelty_features", recording)
        monkeypatch.setenv("STRATUM_FORCE_PALLAS_NOVELTY", "1")
    red, _, names = jnov.make_bpm_reducer(CFG, SR, CFG.frame_size, emit_stride2=emit_stride2,
                                          emit_onset_flux=emit_onset)
    return red, names


def _port_reducer(emit_stride2, emit_onset):
    red, _, names = pnov.make_bpm_reducer(CFG, SR, CFG.frame_size, "cpu",
                                          emit_stride2=emit_stride2, emit_onset_flux=emit_onset)
    return red, names


def _assert_close(ref: dict, got: dict):
    assert set(got) == set(ref)
    for k in ref:
        a, p = np.asarray(ref[k]), got[k].numpy()
        assert a.shape == p.shape, k
        rel = np.max(np.abs(a - p)) / (np.max(np.abs(a)) + 1e-12)
        assert rel < REL_TOL, (k, rel)


@pytest.mark.parametrize("emit_stride2,emit_onset", VARIANTS, ids=IDS)
def test_plain_matches_pallas_interpret(rng, monkeypatch, emit_stride2, emit_onset):
    spec, carry = _inputs(rng)
    captured = {}
    red_j, names_j = _jax_reducer(emit_stride2, emit_onset, monkeypatch, captured)
    ref, carry_j = red_j(jnp.asarray(spec), jnp.arange(spec.shape[1]),
                         jnp.ones(spec.shape[:2], bool), jnp.asarray(carry))
    assert captured["emit_stride2"] == emit_stride2 and captured["emit_onset"] == emit_onset
    red_p, names_p = _port_reducer(emit_stride2, emit_onset)
    got, carry_p = red_p(torch.as_tensor(spec), None, None, torch.as_tensor(carry))
    assert names_p == names_j
    _assert_close(ref, got)
    np.testing.assert_array_equal(carry_p.numpy(), np.asarray(carry_j))


@pytest.mark.parametrize("emit_stride2,emit_onset", VARIANTS, ids=IDS)
def test_reducer_matches_jax_xla_reducer(rng, emit_stride2, emit_onset):
    spec, carry = _inputs(rng, c=96)
    red_j, _ = _jax_reducer(emit_stride2, emit_onset)
    ref, _ = red_j(jnp.asarray(spec), jnp.arange(spec.shape[1]),
                   jnp.ones(spec.shape[:2], bool), jnp.asarray(carry))
    red_p, _ = _port_reducer(emit_stride2, emit_onset)
    got, _ = red_p(torch.as_tensor(spec), None, None, torch.as_tensor(carry))
    _assert_close(ref, got)


def test_packed_layout_matches_pallas_interpret(rng):
    """The packed [B, C, 128] array itself, column for column, with every
    unused column 0 (the base variant, with mel)."""
    spec, carry = _inputs(rng, c=40)
    tables = pnov.novelty_tables(CFG, SR, CFG.frame_size)
    ref = np.asarray(novelty_pallas.fused_novelty_features(
        jnp.asarray(spec), jnp.asarray(carry), tables.sf_mask, tables.ew, tables.mel_w,
        sf_k=tables.sf_k, edge_bands=tables.sub_bands, emit_stride2=True, emit_onset=True,
        use_mel=True, interpret=True))
    got = pops.fused_novelty_features(torch.as_tensor(spec), torch.as_tensor(carry), tables,
                                      emit_stride2=True, emit_onset=True, use_mel=True).numpy()
    assert got.shape == ref.shape == (2, 40, pops.PCOLS)
    used = 4 * tables.nb + tables.nm + 1
    assert not got[..., used:].any()
    scale = np.abs(ref).max(axis=(0, 1)) + 1e-12
    assert (np.abs(got - ref).max(axis=(0, 1)) / scale).max() < REL_TOL


def test_tables_match_jax(monkeypatch, rng):
    """The tables the port builds equal the ones the JAX reducer hands its
    kernel, and the packed columns fit as ``_build_projections`` requires."""
    captured = {}
    red_j, _ = _jax_reducer(True, True, monkeypatch, captured)
    spec, carry = _inputs(rng, b=1, c=8)
    red_j(jnp.asarray(spec), jnp.arange(8), jnp.ones((1, 8), bool), jnp.asarray(carry))
    tables = pnov.novelty_tables(CFG, SR, CFG.frame_size)
    np.testing.assert_array_equal(tables.sf_mask, captured["sf_mask"])
    np.testing.assert_array_equal(tables.ew, captured["ew"])
    np.testing.assert_array_equal(tables.mel_w, captured["mel_w"])
    assert tables.sf_k == captured["sf_k"]
    assert tables.sub_bands == tuple(captured["edge_bands"])
    for got, ref in zip(novelty_pallas._build_projections(tables.sf_mask, tables.ew,
                                                          tables.mel_w, 1152),
                        novelty_pallas._build_projections(captured["sf_mask"], captured["ew"],
                                                          captured["mel_w"], 1152)):
        np.testing.assert_array_equal(got, ref)


def test_too_many_packed_columns_raise():
    """Both packings refuse more than 128 columns (4*nb + nm + 1)."""
    cfg = CFG.replace(tempogram_mel_n_mels=112)
    with pytest.raises(ValueError, match="exceed 128"):
        pnov.novelty_tables(cfg, SR, CFG.frame_size)
    tables = pnov.novelty_tables(CFG, SR, CFG.frame_size)
    with pytest.raises(AssertionError, match="exceed 128"):
        novelty_pallas._build_projections(tables.sf_mask, tables.ew,
                                          np.zeros((1025, 112), np.float32), 1152)


def test_decimate_features_2x_exact(rng):
    b, f, nb, nm = 3, 21, 4, 40
    feats = {k: rng.random((b, f, n)).astype(np.float32)
             for k, n in (("superflux", nb), ("superflux2", nb), ("energy", nb), ("hfc", nb),
                          ("mel", nm))}
    counts = np.asarray([0, 1, 20], np.int32)
    ref, ref_n = jnov.decimate_features_2x({k: jnp.asarray(v) for k, v in feats.items()},
                                           jnp.asarray(counts))
    got, got_n = pnov.decimate_features_2x({k: torch.as_tensor(v) for k, v in feats.items()},
                                           torch.as_tensor(counts))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(ref_n))
    assert pnov.active_band_names(CFG, SR, 2048) == jnov.active_band_names(CFG, SR, 2048)


def test_kernel_input_checks(rng):
    """What the CUDA wrapper refuses before a launch, checked on the CPU."""
    spec, carry = (torch.as_tensor(x) for x in _inputs(rng, c=8))
    tables = pnov.novelty_tables(CFG, SR, CFG.frame_size)
    pops.check_kernel_input(spec, carry, tables, use_mel=True)
    for bad in ((spec.double(), carry), (spec, carry[:, :1]), (spec[..., :-1], carry)):
        with pytest.raises(ValueError, match="kernel takes f32"):
            pops.check_kernel_input(*bad, tables, use_mel=True)
    overlap = pops.NoveltyTables(((0, 1025), (1, 300), (200, 600)), 4, None)
    with pytest.raises(ValueError, match="disjoint"):
        pops.check_kernel_input(spec, carry, overlap, use_mel=False)
    with pytest.raises(ValueError, match="mel filterbank"):
        pops.check_kernel_input(spec, carry, overlap, use_mel=True)
    wide = pops.NoveltyTables(((0, 4097),), 4, None)
    x = torch.zeros((1, 2, 4097))
    with pytest.raises(ValueError, match="at most 2048 bins"):
        pops.check_kernel_input(x, x, wide, use_mel=False)


@pytest.mark.cuda
@pytest.mark.parametrize("emit_stride2,emit_onset", VARIANTS, ids=IDS)
def test_kernel_matches_plain_on_card(rng, emit_stride2, emit_onset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    spec, carry = _inputs(rng, b=3, c=256)
    dev = torch.device("cuda:0")
    tables = pnov.novelty_tables(CFG, SR, CFG.frame_size)
    args = (torch.as_tensor(spec, device=dev), torch.as_tensor(carry, device=dev), tables)
    flags = dict(emit_stride2=emit_stride2, emit_onset=emit_onset, use_mel=True)
    before = pops.fused_novelty_features.launches
    got = pops.fused_novelty_features(*args, **flags)
    assert pops.fused_novelty_features.launches == before + 1
    ref = pops.fused_novelty_features_plain(*args, **flags)
    scale = ref.abs().amax(dim=(0, 1)) + 1e-12
    assert float(((got - ref).abs().amax(dim=(0, 1)) / scale).max()) < REL_TOL
