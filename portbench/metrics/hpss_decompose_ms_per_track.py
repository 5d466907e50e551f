"""Milliseconds a track of the port's HPSS decomposition (``hpss_decompose``:
ten iterations of the two masked medians) on the cell's first batch: its
magnitude spectrogram ``[B, F, K]`` made by the benchmark's own
``torch.stft`` (the pipeline's frame, hop and window length), then one call
between two synchronisations on the host clock."""

import time

import torch


def read(ctx):
    run = ctx.run
    if run.device.type != "cuda" or not hasattr(ctx.driver, "ring"):
        return None
    from stratum_dsp_tpu_torch.features.onset.hpss import hpss_decompose

    _, samples, lengths = ctx.driver.ring[0]
    frame, hop = run.port_cfg.frame_size, run.port_cfg.hop_size
    window = torch.hann_window(frame, periodic=False, device=run.device)
    with torch.no_grad():
        spec = torch.stft(samples, frame, hop, window=window, center=False,
                          return_complex=True).abs().transpose(1, 2).contiguous()
        counts = torch.where(lengths >= frame, (lengths - frame) // hop + 1, 0)
        torch.cuda.synchronize(run.device)
        t0 = time.perf_counter()
        hpss_decompose(spec, counts, run.port_cfg.hpss_margin)
        torch.cuda.synchronize(run.device)
        seconds = time.perf_counter() - t0
    return seconds * 1e3 / samples.shape[0]
