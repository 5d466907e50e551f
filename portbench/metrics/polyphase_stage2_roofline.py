"""Kernel A's share of its roofline over the traced window (per cent): the
least time an H100 could take for the window's key STFT stage 2, counted
from every track's key STFT frames, over the device time of the kernel's
launches. None where the kernel ran in no launch of the window."""

from portbench import roofline, trace
from portbench.layers import frames, track_samples
from portbench.reference.plain.features.key.pipeline import _key_keep_bins, _key_stft_params

KERNEL = "polyphase_stage2_kernel"


def read(ctx):
    if ctx.summary is None:
        return None
    spent = trace.device_seconds(ctx.summary, KERNEL)
    if not spent:
        return None
    run = ctx.run
    frame_size, hop = _key_stft_params(run.port_cfg)
    keep = _key_keep_bins(run.port_cfg, run.sample_rate, frame_size)
    n_bytes = n_ops = 0
    for host in ctx.window["outputs"]:
        n = track_samples(host, run.sample_rate)
        b, o = roofline.polyphase_work(frames(n, frame_size, hop), frame_size // hop, keep)
        n_bytes, n_ops = n_bytes + b, n_ops + o
    return 100.0 * roofline.least_seconds(n_bytes, n_ops) / spent
