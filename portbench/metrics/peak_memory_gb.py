"""The device's peak allocated memory over the window (``torch.cuda.
max_memory_allocated``, reset at the window's start), in GB."""


def read(ctx):
    if ctx.run.device.type != "cuda":
        return None
    return ctx.peak_window_bytes / 1e9
