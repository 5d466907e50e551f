"""The analysis's constant tables on a device, each made once and shared.

``on(device, make, *args, site=...)`` caches the tables ``make`` makes from
``args`` per (make, args, device) in a bounded LRU cache: keyed by the
function and its hashable arguments, never by an array's contents. With
``site``, ``make(*args)`` returns numpy arrays (one, or a tuple or dict of
them; other values pass as they are), copied to the device inside
``tracing.host_read(site)``: a copy from pageable memory waits for the
stream, so it is made, and counted, once a device. Without, ``make(*args,
device=device)`` makes its tensors on the device (the DFT bases, whose bits
come from the device's arithmetic). No caller may write into a returned
tensor: every caller shares it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tracing

CACHE_SIZE = 256  # entries; a configuration's pipeline holds about 25 a device


def on(device, make, *args, site: str = None):
    """``make``'s tables for ``args`` on ``device`` (``None``: the CPU;
    ``"cuda"``: the current card, sharing ``cuda:<current>``'s entry)."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _cached(dev, make, site, *args)


@functools.lru_cache(maxsize=CACHE_SIZE, typed=True)
def _cached(device, make, site, *args):
    if site is None:
        return make(*args, device=device)
    with tracing.host_read(site):
        return _copy(make(*args), device)


def _copy(value, device):
    if isinstance(value, np.ndarray):
        return torch.as_tensor(value, device=device)
    if isinstance(value, tuple):
        return tuple(_copy(v, device) for v in value)
    if isinstance(value, dict):
        return {k: _copy(v, device) for k, v in value.items()}
    return value
