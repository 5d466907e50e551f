"""The direct DFT kernel's share of its roofline over the traced window (per
cent): the least time an H100 could take for the window's windowed DFT
magnitudes, counted from the tracks' frames (the base pass's hop-512 frames
of every track and the hop-256 frames of every escalated track), over the
device time of the kernel's launches. None where the kernel ran in no launch
of the window.

The work is that of ``bound_ms`` beside the wrapper
(``stratum_dsp_tpu_torch/ops/stft.py stft_magnitude_bound_ms``): a multiply
and an add a sample for each of the ``2 keep`` basis columns, over the dense
bf16 rate of the tensor cores, against each track's samples read once and its
f32 magnitudes written once, over the memory's bandwidth; here each track's
frames are counted once, so padded chunks and tiles count for nothing."""

from portbench import roofline, trace
from portbench.layers import frames, track_samples

KERNEL = "stft_magnitude_kernel"
ESCALATION_HOP = 256
H100_BF16_OPS_PER_S = 989e12  # dense bf16 on the tensor cores (NVIDIA's data sheet; 700 W)


def work(track_frames, n: int, hop: int, keep: int) -> tuple:
    """``(bytes, ops)`` of the magnitudes of tracks of ``track_frames``
    frames of ``n`` samples at ``hop``, ``keep`` bins each."""
    total = sum(track_frames)
    n_bytes = sum(4 * ((f - 1) * hop + n) for f in track_frames if f > 0) + 4 * total * keep
    return n_bytes, 2 * total * n * 2 * keep


def read(ctx):
    if ctx.summary is None:
        return None
    spent = trace.device_seconds(ctx.summary, KERNEL)
    if not spent:
        return None
    cfg = ctx.run.port_cfg
    n, keep = cfg.frame_size, cfg.frame_size // 2 + 1
    n_bytes = n_ops = 0
    for host in ctx.window["outputs"]:
        samples = track_samples(host, ctx.run.sample_rate)
        b, o = work(frames(samples, n, cfg.hop_size), n, cfg.hop_size, keep)
        n_bytes, n_ops = n_bytes + b, n_ops + o
        if cfg.enable_tempogram_multi_resolution and cfg.hop_size == 512:
            esc = samples[host["multi_res_triggered"].astype(bool)]
            b, o = work(frames(esc, n, ESCALATION_HOP), n, ESCALATION_HOP, keep)
            n_bytes, n_ops = n_bytes + b, n_ops + o
    least = max(n_bytes / roofline.H100_BYTES_PER_S, n_ops / H100_BF16_OPS_PER_S)
    return 100.0 * least / spent
