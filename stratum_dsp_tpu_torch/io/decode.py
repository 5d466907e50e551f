"""Audio decode (the port's copy of ``stratum_dsp_tpu/io/decode.py``): the
native C++ library (WAV; FLAC via the from-scratch decoder in
native/flac_decoder.cpp; MP3 via libmpg123; OGG via libvorbisfile; threaded
batch pool) with a pure-Python WAV fallback.

The native library (``native/stratum_audio.cpp``, shared with the JAX
package and not edited here) replaces the reference's symphonia decode layer
(examples/analyze_file.rs:25-180) and rayon batch pool
(examples/analyze_batch.rs:239-262). It is built on demand with g++ into
``io/_build/`` of this package (named by a hash of the sources, so an edited
source is rebuilt) and loaded via ctypes; if the toolchain is unavailable, WAV
decoding falls back to the stdlib ``wave`` module.

Decoding is host work in both packages: this is the one part of the port
that runs on the CPU without being asked to. The fixture encoders of the JAX
module (``encode_m4a``, ``encode_audio``) are not ported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import wave
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
# STRATUM_NATIVE_DIR overrides the source directory for installs where the
# package does not live inside the repo checkout.
_NATIVE_DIR = Path(os.environ.get("STRATUM_NATIVE_DIR", _REPO_ROOT / "native"))
_NATIVE_SOURCES = tuple(_NATIVE_DIR / name for name in (
    "stratum_audio.cpp", "flac_decoder.cpp", "ffmpeg_decoder.cpp"))
_BUILD_DIR = Path(__file__).resolve().parent / "_build"

MIX_AVERAGE = 0
MIX_DOMINANT = 1

_ERR_NAMES = {
    1: "could not open file",
    2: "unrecognized format",
    3: "unsupported sample format",
    4: "allocation failure",
    5: "mp3 decoding unavailable (libmpg123 not found)",
    6: "ogg decoding unavailable (libvorbisfile not found)",
    7: "ffmpeg decoding unavailable (libavformat/libavcodec not found)",
}


def _build_native() -> Optional[Path]:
    """The library for the current sources, compiled if it is missing; None
    where the sources or the toolchain are."""
    if not all(src.exists() for src in _NATIVE_SOURCES):
        return None
    digest = hashlib.sha256()
    for src in _NATIVE_SOURCES:
        digest.update(src.read_bytes())
    path = _BUILD_DIR / f"libstratum_audio_{digest.hexdigest()[:16]}.so"
    if path.exists():
        return path
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # built beside its final name and moved there whole: another process
        # that builds at the same time replaces it with an equal file
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
            lib = os.path.join(tmp, path.name)
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", lib,
                 *map(str, _NATIVE_SOURCES), "-ldl", "-lpthread"],
                check=True, capture_output=True, timeout=120)
            os.replace(lib, path)
    except (OSError, subprocess.SubprocessError):
        return None
    return path


@functools.lru_cache(maxsize=1)
def native_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native decoder; None if unavailable.
    Decided once per process."""
    path = _build_native()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.sa_decode_file.restype = ctypes.c_int
    lib.sa_decode_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
    ]
    lib.sa_free.restype = None
    lib.sa_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.sa_decode_batch.restype = None
    lib.sa_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.sa_ffmpeg_available.restype = ctypes.c_int
    lib.sa_ffmpeg_available.argtypes = []
    return lib


def decoder_backend() -> str:
    """``"native"`` when the C++ library decodes, ``"stdlib"`` when only the
    ``wave`` fallback is available (no g++ or no sources)."""
    return "native" if native_lib() is not None else "stdlib"


def _decode_wav_python(path: str, mix_mode: int) -> Tuple[np.ndarray, int]:
    """stdlib WAV fallback (PCM 8/16/32; 24-bit handled manually)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = (
            (b[:, 0].astype(np.int32) << 8)
            | (b[:, 1].astype(np.int32) << 16)
            | (b[:, 2].astype(np.int32) << 24)
        ).astype(np.int32)
        x = (x >> 8).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    x = x.reshape(-1, ch)
    if ch == 1:
        mono = x[:, 0]
    elif mix_mode == MIX_DOMINANT and ch == 2:
        mono = np.where(np.abs(x[:, 0]) >= np.abs(x[:, 1]), x[:, 0], x[:, 1])
    else:
        mono = x.mean(axis=1)
    return np.ascontiguousarray(mono, np.float32), sr


def decode_file(path: str, target_sr: int = 0,
                mix_mode: int = MIX_AVERAGE) -> Tuple[np.ndarray, int]:
    """Decode one file to mono float32. Returns (samples, sample_rate)."""
    lib = native_lib()
    if lib is not None:
        out = ctypes.POINTER(ctypes.c_float)()
        n = ctypes.c_int64()
        sr = ctypes.c_int()
        rc = lib.sa_decode_file(path.encode(), target_sr, mix_mode, ctypes.byref(out),
                                ctypes.byref(n), ctypes.byref(sr))
        if rc == 0:
            arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
            lib.sa_free(out)
            return arr, sr.value
        if rc != 5 and not path.lower().endswith(".wav"):
            raise IOError(f"decode failed for {path}: {_ERR_NAMES.get(rc, rc)}")
    samples, sr_out = _decode_wav_python(path, mix_mode)
    if target_sr and sr_out != target_sr:
        # linear resample to target (native path does this in C++)
        ratio = sr_out / target_sr
        n_out = int(len(samples) / ratio)
        pos = np.arange(n_out) * ratio
        i0 = pos.astype(np.int64)
        i1 = np.minimum(i0 + 1, len(samples) - 1)
        frac = (pos - i0).astype(np.float32)
        samples = samples[i0] * (1 - frac) + samples[i1] * frac
        sr_out = target_sr
    return samples.astype(np.float32), sr_out


def ffmpeg_available() -> bool:
    """True if the dlopen'd libavformat/libavcodec path is usable."""
    lib = native_lib()
    return bool(lib is not None and lib.sa_ffmpeg_available())


def decode_batch(paths: Sequence[str], target_sr: int = 0, mix_mode: int = MIX_AVERAGE,
                 n_threads: int = 0) -> List[Tuple[Optional[np.ndarray], int, Optional[str]]]:
    """Threaded batch decode. Returns [(samples|None, sr, error|None)]."""
    lib = native_lib()
    if lib is None:
        out = []
        for p in paths:
            try:
                s, sr = decode_file(p, target_sr, mix_mode)
                out.append((s, sr, None))
            except (OSError, ValueError, EOFError, wave.Error) as e:
                out.append((None, 0, str(e)))
        return out

    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    outs = (ctypes.POINTER(ctypes.c_float) * n)()
    lens = (ctypes.c_int64 * n)()
    srs = (ctypes.c_int * n)()
    errs = (ctypes.c_int * n)()
    lib.sa_decode_batch(c_paths, n, target_sr, mix_mode, n_threads, outs, lens, srs, errs)
    results = []
    for i in range(n):
        if errs[i] == 0:
            arr = np.ctypeslib.as_array(outs[i], shape=(lens[i],)).copy()
            lib.sa_free(outs[i])
            results.append((arr, srs[i], None))
        else:
            results.append((None, 0, _ERR_NAMES.get(errs[i], str(errs[i]))))
    return results
