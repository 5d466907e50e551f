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

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stratum_dsp_tpu.config import AnalysisConfig
from stratum_dsp_tpu.features.period import novelty as jnov
from stratum_dsp_tpu.ops import novelty_pallas
from stratum_dsp_tpu_torch.config import AnalysisConfig as PortConfig
from stratum_dsp_tpu_torch.features.period import novelty as pnov
from stratum_dsp_tpu_torch.ops import novelty as pops

torch.set_num_threads(2)

CFG = AnalysisConfig()
PCFG = PortConfig.from_dict(dataclasses.asdict(CFG))  # the port's own class
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
    red, _, names = pnov.make_bpm_reducer(PCFG, SR, CFG.frame_size, "cpu",
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


@pytest.mark.parametrize("b,c,mel", [(1, 5, True), (12, 37, True), (1, 37, False),
                                     (12, 5, False)],
                         ids=["B1-C5", "B12-C37", "B1-C37-mel-off", "B12-C5-mel-off"])
def test_plain_matches_pallas_interpret_ragged(rng, b, c, mel):
    """The ragged shapes the CUDA kernel must also take (one track and the
    escalation's 12 gathered rows, frame counts below a tile and no multiple
    of one, mel off): the plain version, which the kernel is held to on the
    card, against the Pallas kernel in interpret mode, column for column."""
    cfg = PCFG if mel else PCFG.replace(enable_tempogram_mel_novelty=False)
    tables = pnov.novelty_tables(cfg, SR, CFG.frame_size)
    spec, carry = _inputs(rng, b=b, c=c)
    spec[0, c // 2:] = 0.0  # frames past the track's end
    ref = np.asarray(novelty_pallas.fused_novelty_features(
        jnp.asarray(spec), jnp.asarray(carry), tables.sf_mask, tables.ew, tables.mel_w,
        sf_k=tables.sf_k, edge_bands=tables.sub_bands, emit_stride2=True, emit_onset=True,
        use_mel=mel, interpret=True))
    got = pops.fused_novelty_features(torch.as_tensor(spec), torch.as_tensor(carry), tables,
                                      emit_stride2=True, emit_onset=True, use_mel=mel).numpy()
    assert got.shape == ref.shape == (b, c, pops.PCOLS)
    scale = np.abs(ref).max(axis=(0, 1)) + 1e-12
    assert (np.abs(got - ref).max(axis=(0, 1)) / scale).max() < REL_TOL


def test_bound_at_the_main_path_shape():
    """Bytes and operations of one launch at [40, 256, 1025] -> [40, 256, 128]:
    42.0 MB + 0.3 MB read and 5.2 MB written once each; bytes bound both
    variants."""
    tables = pnov.novelty_tables(PCFG, SR, CFG.frame_size)
    n_pack = tables.mel_packed[1].size
    base = pops.bound_ms(40, 256, 1025, tables.nb, tables.nm, n_pack, tables.sf_k,
                         emit_stride2=True, emit_onset=True, use_mel=True)
    assert base["bytes"] == 4 * (40 * 256 * 1025 + 40 * 2 * 1025 + 40 * 256 * 128) == 47_554_880
    assert base["operations"] == 40 * 256 * (1025 * 32 + 2 * n_pack)
    assert base["bound_by"] == "bytes"
    assert base["bound_ms"] == pytest.approx(47_554_880 / 3.35e12 * 1e3)
    aux = pops.bound_ms(40, 256, 1025, tables.nb, tables.nm, n_pack, tables.sf_k,
                        emit_stride2=False, emit_onset=False, use_mel=True)
    assert aux["bytes"] == base["bytes"] and aux["bound_by"] == "bytes"
    assert aux["operations"] == 40 * 256 * (1025 * 21 + 2 * n_pack)


def test_kernel_tile():
    """The tile and shared memory of a launch: at the chosen tile two blocks
    of the main path's rows fit an SM, a warp a row; and the largest tables
    the kernel's input check admits still fit one block."""
    tables = pnov.novelty_tables(PCFG, SR, CFG.frame_size)
    sizes = (tables.mel_packed[1].size, len(tables.edge_windows), len(tables.mel_tasks[0]))
    tile = pops.FRAME_TILE
    assert (tile + 2) * 32 == pops.BLOCK_THREADS
    smem = pops.kernel_smem_bytes(1025, tile, *sizes)
    assert smem == 4 * (16 * 1036 + 14 * 128 + 676 + 16 + 257 + 4 * 24 + 4 * 50)
    assert smem <= pops.KERNEL_MAX_SMEM // 2
    worst = pops.kernel_smem_bytes(pops.KERNEL_MAX_BINS, tile, pops.KERNEL_MAX_MEL_PACKED,
                                   pops.KERNEL_MAX_EDGES, pops.KERNEL_MAX_MEL_TASKS)
    assert worst <= pops.KERNEL_MAX_SMEM


def test_band_bytes_edge_windows_and_mel_tasks():
    """The kernel's tables at the default config: a band byte per bin, the
    24 bins within sf_k of a sub-band's edge with their clamped windows, and
    the mel filters as lane tasks of at most MEL_TASK_BINS bins whose pieces
    tile each filter's range."""
    tables = pnov.novelty_tables(PCFG, SR, CFG.frame_size)
    bands = tables.bin_band
    assert bands.shape == (1028,) and bands.dtype == np.uint8
    for i, s, e in tables.sub_bands:
        assert (bands[s:e] == i).all()
    assert (bands != 0).sum() == sum(e - s for _, s, e in tables.sub_bands)
    edges = tables.edge_windows
    assert edges.shape == (24, 4) and edges[0].tolist() == [1, 1, 5, 1]
    assert sorted(set(edges[:, 0].tolist())) == [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 89, 90,
                                                 91, 92, 93, 94, 95, 96, 368, 369, 370, 371]
    rng_, pack = tables.mel_packed
    assert rng_.shape == (40, 3) and pack.size == int((rng_[:, 1] - rng_[:, 0]).sum())
    dense = np.zeros_like(tables.mel_w)
    for m, (lo, hi, off) in enumerate(rng_):
        dense[lo:hi, m] = pack[off:off + hi - lo]
    np.testing.assert_array_equal(dense, tables.mel_w)
    tasks, rounds = tables.mel_tasks
    assert rounds[0] == 0 and rounds[-1] == len(tasks) and (np.diff(rounds) > 0).all()
    assert (tasks[:, 1] - tasks[:, 0]).max() <= pops.MEL_TASK_BINS
    rebuilt = np.zeros_like(tables.mel_w)
    for lo, hi, off, col in tasks:
        assert not rebuilt[lo:hi, col - 4 * tables.nb].any()  # pieces do not overlap
        rebuilt[lo:hi, col - 4 * tables.nb] = pack[off:off + hi - lo]
    np.testing.assert_array_equal(rebuilt, tables.mel_w)


def test_packed_layout_matches_pallas_interpret(rng):
    """The packed [B, C, 128] array itself, column for column, with every
    unused column 0 (the base variant, with mel)."""
    spec, carry = _inputs(rng, c=40)
    tables = pnov.novelty_tables(PCFG, SR, CFG.frame_size)
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
    tables = pnov.novelty_tables(PCFG, SR, CFG.frame_size)
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
    cfg = PCFG.replace(tempogram_mel_n_mels=112)
    with pytest.raises(ValueError, match="exceed 128"):
        pnov.novelty_tables(cfg, SR, CFG.frame_size)
    tables = pnov.novelty_tables(PCFG, SR, CFG.frame_size)
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
    assert pnov.active_band_names(PCFG, SR, 2048) == jnov.active_band_names(CFG, SR, 2048)


def test_kernel_input_checks(rng):
    """What the CUDA wrapper refuses before a launch, checked on the CPU."""
    spec, carry = (torch.as_tensor(x) for x in _inputs(rng, c=8))
    tables = pnov.novelty_tables(PCFG, SR, CFG.frame_size)
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
    tables = pnov.novelty_tables(PCFG, SR, CFG.frame_size)
    args = (torch.as_tensor(spec, device=dev), torch.as_tensor(carry, device=dev), tables)
    flags = dict(emit_stride2=emit_stride2, emit_onset=emit_onset, use_mel=True)
    before = pops.fused_novelty_features.launches
    got = pops.fused_novelty_features(*args, **flags)
    assert pops.fused_novelty_features.launches == before + 1
    ref = pops.fused_novelty_features_plain(*args, **flags)
    scale = ref.abs().amax(dim=(0, 1)) + 1e-12
    assert float(((got - ref).abs().amax(dim=(0, 1)) / scale).max()) < REL_TOL


@pytest.mark.cuda
def test_kernel_takes_a_whole_spectrogram_in_one_launch_on_card(rng):
    """The percussive fallback's call: the auxiliary variant over every frame
    of a track with a zero carry, held to the plain version taken a slab of
    frames at a time (the two frames before a slab as its carry)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda:0")
    tables = pnov.novelty_tables(PCFG, SR, CFG.frame_size)
    spec = torch.rand((2, 3001, tables.n_bins), device=dev) * 3.0
    spec[1, 2000:] = 0.0
    carry = torch.zeros((2, 2, tables.n_bins), device=dev)
    flags = dict(emit_stride2=False, emit_onset=False, use_mel=True)
    before = pops.fused_novelty_features.launches
    got = pops.fused_novelty_features(spec, carry, tables, **flags)
    assert pops.fused_novelty_features.launches == before + 1
    ref = torch.cat([pops.fused_novelty_features_plain(
        spec[:, f0:f0 + 512], carry if f0 == 0 else spec[:, f0 - 2:f0], tables, **flags)
        for f0 in range(0, spec.shape[1], 512)], dim=1)
    scale = ref.abs().amax(dim=(0, 1)) + 1e-12
    assert float(((got - ref).abs().amax(dim=(0, 1)) / scale).max()) < REL_TOL


def _emulate_kernel_tables(spec, prev2, tables, emit_stride2, emit_onset, use_mel):
    """The CUDA kernel's decomposition in numpy: one full-band max filter per
    row and stride, summed into the sub-bands by ``tables.bin_band``; the
    bins of ``tables.edge_windows`` trade that term for their own band's
    window; the mel dots piece by piece from ``tables.mel_tasks``, later
    rounds adding to the first; float64 sums."""
    b, c, k = spec.shape
    nb, nm, rad = tables.nb, tables.nm, tables.sf_k
    ext = np.concatenate([prev2, spec], axis=1).astype(np.float64)
    logs = np.log1p(np.maximum(ext, 0.0))
    out = np.zeros((b, c, pops.PCOLS))
    band_of = tables.bin_band[:k]
    assert tables.bin_band.size % 4 == 0 and not tables.bin_band[k:].any()

    def wmax(row, lo, hi):
        return row[..., lo:hi + 1].max(axis=-1)

    def filtered(row):
        return np.stack([wmax(row, max(kk - rad, 0), min(kk + rad, k - 1)) for kk in range(k)],
                        axis=-1)

    for f in range(c):
        cur = logs[:, f + 2]
        for col0, prev, on in ((0, logs[:, f + 1], True), (nb, logs[:, f], emit_stride2)):
            if not on:
                continue
            d2 = np.maximum(cur - filtered(prev), 0.0) ** 2
            out[:, f, col0] = d2.sum(-1)
            for q in range(1, nb):
                out[:, f, col0 + q] = d2[:, band_of == q].sum(-1)
            for kk, lo, hi, band in tables.edge_windows:
                own = np.maximum(cur[:, kk] - wmax(prev, lo, hi), 0.0) ** 2
                out[:, f, col0 + band] += own - d2[:, kk]
        x2 = ext[:, f + 2] ** 2
        for q in range(nb):
            sel = np.ones(k, bool) if q == 0 else band_of == q
            out[:, f, 2 * nb + 2 * q] = x2[:, sel].sum(-1)
            out[:, f, 2 * nb + 2 * q + 1] = (x2 * np.arange(k))[:, sel].sum(-1)
        if use_mel:
            tasks, rounds = tables.mel_tasks
            pack = tables.mel_packed[1].astype(np.float64)
            for r in range(len(rounds) - 1):
                cols = [t[3] for t in tasks[rounds[r]:rounds[r + 1]]]
                assert len(set(cols)) == len(cols)  # a round writes a column once
                for lo, hi, off, col in tasks[rounds[r]:rounds[r + 1]]:
                    dot = cur[:, lo:hi] @ pack[off:off + hi - lo]
                    out[:, f, col] = dot if r == 0 else out[:, f, col] + dot
        if emit_onset:
            cm, pm = ext[:, f + 2].max(-1, keepdims=True), ext[:, f + 1].max(-1, keepdims=True)
            cn = np.where(cm > pops.EPSILON, ext[:, f + 2] / np.maximum(cm, pops.EPSILON), 0.0)
            pn = np.where(pm > pops.EPSILON, ext[:, f + 1] / np.maximum(pm, pops.EPSILON), 0.0)
            out[:, f, 4 * nb + nm] = np.sqrt((np.maximum(cn - pn, 0.0) ** 2).sum(-1))
    out[..., :2 * nb] = np.sqrt(np.maximum(out[..., :2 * nb], 0.0))
    return out


KERNEL_TABLE_CASES = {
    "default": lambda: pnov.novelty_tables(PCFG, SR, CFG.frame_size),
    "mel-off": lambda: pnov.novelty_tables(PCFG.replace(enable_tempogram_mel_novelty=False), SR,
                                           CFG.frame_size),
    "full-band-only": lambda: pnov.novelty_tables(
        PCFG.replace(enable_tempogram_band_fusion=False), SR, CFG.frame_size),
    "narrow-bands": lambda: pops.NoveltyTables(((0, 96), (0, 3), (3, 9), (40, 96)), 4, None),
    "radius-2-gap": lambda: pops.NoveltyTables(((0, 64), (5, 20), (20, 22), (30, 50)), 2, None),
}


@pytest.mark.parametrize("case", KERNEL_TABLE_CASES)
def test_kernel_tables_reproduce_plain(rng, case):
    """The tables the CUDA kernel walks (a band byte per bin, the bins whose
    sub-band window is narrower than the full band's, the mel filters cut
    into lane-sized tasks) give the plain version's output, for wide,
    narrow, adjacent and gapped sub-bands."""
    tables = KERNEL_TABLE_CASES[case]()
    use_mel = tables.mel_w is not None
    spec = rng.random((2, 3, tables.n_bins)).astype(np.float32) * 3.0
    spec[1, 1] = 0.0
    carry = rng.random((2, 2, tables.n_bins)).astype(np.float32)
    pops.check_kernel_input(torch.as_tensor(spec), torch.as_tensor(carry), tables, use_mel)
    ref = pops.fused_novelty_features_plain(
        torch.as_tensor(spec), torch.as_tensor(carry), tables, emit_stride2=True,
        emit_onset=True, use_mel=use_mel).numpy()
    got = _emulate_kernel_tables(spec, carry, tables, True, True, use_mel)
    scale = np.abs(ref).max(axis=(0, 1)) + 1e-12
    assert (np.abs(got - ref).max(axis=(0, 1)) / scale).max() < REL_TOL
