"""Build and load the port's hand-written CUDA kernels.

The sources in ``stratum_dsp_tpu_torch/csrc/*.cu`` have a plain C interface.
On first use they are compiled with ``nvcc`` for ``sm_90a``, one ``nvcc``
process per source, all started together, and linked into one shared
library under ``csrc/_build/`` (named by a hash of the sources, so an edited
source is rebuilt) that is loaded with ``ctypes``. Nothing here runs at import
time: the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC_DIR / "_build"
# IEEE division and square root, denormals kept (the Viterbi kernel's
# products underflow through them): nvcc's defaults, stated
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
)

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory, and
# f32 outside the tensor cores. Every kernel's bound is stated against them.
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12

_vp, _int = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> (argtypes, restype)
_SIGNATURES = {
    "stratum_polyphase_stage2": ([_vp, _vp, _vp] + [_int] * 7 + [_vp], _int),
    "stratum_downbeat_mask": ([_vp, _vp, _vp, _vp, _int, _int, _vp], _int),
    "stratum_downbeat_max_slots": ([], _int),
    "stratum_fused_novelty": ([_vp] * 8 + [_int] * 13 + [_vp], _int),
    "stratum_fused_novelty_smem": ([_int] * 5, _int),
    "stratum_viterbi_decode": ([_vp, _vp, _vp, _int, _int, _vp], _int),
    "stratum_viterbi_max_frames": ([], _int),
    "stratum_viterbi_backtrack": ([_vp, _vp, _vp, _int, _int, _vp], _int),
    "stratum_empty_launch": ([_int, _int, _int, _vp], _int),
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libstratum_kernels_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple:
    """Compile the kernels if the library for the current sources is missing.

    Returns ``(path, seconds)``; ``seconds`` is 0.0 when nothing was built.
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report.
    """
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_sources(), objs)]
        reports = [(src.name, proc.communicate()[0], proc.returncode)
                   for src, proc in zip(_sources(), procs)]
        failed = [f"{name} ({rc}):\n{log}" for name, log, rc in reports if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        if verbose:
            for name, log, _ in reports:
                print(f"{name}:\n{log}", end="")
        lib = os.path.join(tmp, path.name)
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, path)
    return path, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per process)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, under a lock: the shards of a mesh
    on distinct cards launch from one host thread each."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def roofline(n_bytes: int, n_ops: int) -> dict:
    """The least time an H100 could take to move ``n_bytes`` and do ``n_ops``
    f32 operations outside the tensor cores: ``bound_ms`` is the larger of
    the two times and ``bound_by`` names it."""
    bytes_ms = 1e3 * n_bytes / H100_BYTES_PER_S
    ops_ms = 1e3 * n_ops / H100_F32_OPS_PER_S
    return {"bytes": int(n_bytes), "operations": int(n_ops), "bytes_ms": bytes_ms,
            "operations_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
