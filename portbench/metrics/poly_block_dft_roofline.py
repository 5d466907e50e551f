"""The key STFT's stage-1 kernel's share of its roofline over the traced
window (per cent): the least time an H100 could take for the window's
per-hop-block DFTs, counted from each track's key STFT frames at
``key_stft_bins_per_pass``'s bins, times ``key_stft_passes_per_call``'s
passes, over the device time of the kernel's launches. None where the kernel
ran in no launch of the window, or where nothing counted the passes or the
bins (a port without the counters).

A track of F frames of R hop blocks each takes F + R - 1 blocks: their f32
samples read once and their bf16 re | im at the ``keep + 1`` bins stage 2
reads written once, over the memory's bandwidth; a multiply and an add a
sample for each of those ``2 (keep + 1)`` columns, over the dense bf16 rate
of the tensor cores. Padded chunks, halos and the columns past ``keep + 1``
count for nothing, so the share can read low, never high."""

from portbench import harness, roofline, trace
from portbench.layers import frames, track_samples
from portbench.reference.plain.features.key.pipeline import _key_stft_params

KERNEL = "poly_block_dft_kernel"
H100_BF16_OPS_PER_S = 989e12  # dense bf16 on the tensor cores (NVIDIA's data sheet; 700 W)


def work(track_frames, r: int, hop: int, keep: float) -> tuple:
    """``(bytes, ops)`` of stage 1 over tracks of ``track_frames`` key STFT
    frames at ``R`` blocks a frame of ``hop`` samples, ``keep`` bins."""
    blocks = sum(f + r - 1 for f in track_frames if f > 0)
    cols = 2 * (keep + 1)
    return 4 * blocks * hop + 2 * blocks * cols, 2 * blocks * hop * cols


def read(ctx):
    if ctx.summary is None:
        return None
    spent = trace.device_seconds(ctx.summary, KERNEL)
    bins = harness.load_reader("key_stft_bins_per_pass")(ctx)
    passes = harness.load_reader("key_stft_passes_per_call")(ctx)
    if not spent or bins is None or passes is None:
        return None
    run = ctx.run
    frame_size, hop = _key_stft_params(run.port_cfg)
    n_bytes = n_ops = 0
    for host in ctx.window["outputs"]:
        n = track_samples(host, run.sample_rate)
        b, o = work(frames(n, frame_size, hop), frame_size // hop, hop, bins)
        n_bytes, n_ops = n_bytes + b, n_ops + o
    least = max(n_bytes / roofline.H100_BYTES_PER_S, n_ops / H100_BF16_OPS_PER_S)
    return 100.0 * passes * least / spent
