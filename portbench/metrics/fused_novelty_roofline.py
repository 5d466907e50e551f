"""Kernel D's share of its roofline over the traced window (per cent): the
least time an H100 could take for the window's work of the kernel, counted
from the tracks' frames (the base pass's hop-512 frames of every track and
the hop-256 frames of every escalated track), over the device time of the
kernel's launches. None where the kernel ran in no launch of the window."""

from portbench import roofline, trace
from portbench.layers import frames, track_samples
from portbench.reference.plain.features.period.novelty import novelty_tables

KERNEL = "fused_novelty_kernel"
ESCALATION_HOP = 256


def read(ctx):
    if ctx.summary is None:
        return None
    spent = trace.device_seconds(ctx.summary, KERNEL)
    if not spent:
        return None
    run = ctx.run
    cfg = run.port_cfg
    tables = novelty_tables(cfg, run.sample_rate, cfg.frame_size)
    n_pack = int(tables.mel_packed[1].size) if cfg.enable_tempogram_mel_novelty else 0
    common = dict(k=tables.n_bins, n_pack=n_pack, sf_k=tables.sf_k,
                  use_mel=cfg.enable_tempogram_mel_novelty)
    n_bytes = n_ops = 0
    for host in ctx.window["outputs"]:
        n = track_samples(host, run.sample_rate)
        b, o = roofline.novelty_work(frames(n, cfg.frame_size, cfg.hop_size),
                                     emit_stride2=cfg.enable_tempogram_multi_resolution,
                                     emit_onset=True, **common)
        n_bytes, n_ops = n_bytes + b, n_ops + o
        if cfg.enable_tempogram_multi_resolution and cfg.hop_size == 512:
            esc = n[host["multi_res_triggered"].astype(bool)]
            b, o = roofline.novelty_work(frames(esc, cfg.frame_size, ESCALATION_HOP),
                                         emit_stride2=False, emit_onset=False, **common)
            n_bytes, n_ops = n_bytes + b, n_ops + o
    return 100.0 * roofline.least_seconds(n_bytes, n_ops) / spent
