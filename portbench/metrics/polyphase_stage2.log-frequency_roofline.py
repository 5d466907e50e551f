"""Kernel A's share of its roofline over the traced window (per cent) at the
bins the key STFT's passes kept: the least time an H100 could take for
stage 2 over every track's key STFT frames, at ``key_stft_bins_per_pass``'s
bins, times ``key_stft_passes_per_call``'s passes, over the device time of
the kernel's launches. The bins come from the counter, not from the
configuration, so that the work counted is what the port computed. None
where the kernel ran in no launch of the window, or where nothing counted
the passes or the bins (a port without the counters)."""

from portbench import harness, roofline, trace
from portbench.layers import frames, track_samples
from portbench.reference.plain.features.key.pipeline import _key_stft_params

KERNEL = "polyphase_stage2_kernel"


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
        b, o = roofline.polyphase_work(frames(n, frame_size, hop), frame_size // hop, bins)
        n_bytes, n_ops = n_bytes + b, n_ops + o
    return 100.0 * passes * roofline.least_seconds(n_bytes, n_ops) / spent
