"""Milliseconds a file of the port's decoder (``io.decode.decode_batch``,
the batch CLI's decode pool) over the cell's WAV files once, on the host
clock."""

import time


def read(ctx):
    paths = getattr(ctx.driver, "paths", None)
    if not paths:
        return None
    from stratum_dsp_tpu_torch.io.decode import decode_batch

    t0 = time.perf_counter()
    decoded = decode_batch(paths, target_sr=ctx.run.sample_rate)
    seconds = time.perf_counter() - t0
    if any(err is not None for _, _, err in decoded):
        return None
    return seconds * 1e3 / len(paths)
