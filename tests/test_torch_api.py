"""The port's public surface against the JAX package's: the entry points of
``analysis`` take the JAX parameters in the JAX order, and every name a JAX
subpackage ``__init__`` exports imports from the port's twin. Importing the
port builds no kernel.
"""

import ast
import dataclasses
import importlib
import inspect
import subprocess
import sys
from pathlib import Path

import pytest

import stratum_dsp_tpu.analysis as janalysis
import stratum_dsp_tpu_torch.analysis as panalysis

REPO = Path(__file__).resolve().parents[1]

ENTRY_POINTS = ("analyze_batch", "analyze_batch_arrays", "analyze_batch_timed",
                "decode_results", "stage_timings")
# The port's own parameters: keyword-only, after the JAX ones. ``device``
# names where the batch runs; ``analyze_batch`` passes ``debug_stop_after``
# on to ``analyze_batch_arrays`` (the JAX package's ``stage_timings`` reaches
# it through its own jitted call)
PORT_ONLY = {"analyze_batch": {"device", "debug_stop_after"},
             "analyze_batch_arrays": {"device"},
             "analyze_batch_timed": {"device"},
             "decode_results": set(),
             "stage_timings": {"device"}}

# JAX subpackages whose __init__ exports names, and the port's twins.
# Left out: the root package (its names are held by
# tests/test_torch_config.py).
SUBPACKAGES = ("analysis", "features", "features.beat", "features.chroma", "features.key",
               "features.onset", "features.period", "io", "ml", "ops", "parallel",
               "preprocessing", "testing")
# The scale-out's functions (``parallel/mesh.py``, ``parallel/timeblocks.py``):
# the JAX parameters in the JAX order, kinds and defaults, and no other
PARALLEL_FUNCTIONS = ("mesh.make_mesh", "mesh.pad_batch_for_mesh", "mesh.analyze_batch_sharded",
                      "timeblocks.stft_reduce_sharded", "timeblocks.frame_rms_sharded",
                      "timeblocks.compute_bpm_spectral_features_sharded",
                      "timeblocks.pad_to_time_multiple")
# Names whose JAX form is a Pallas kernel: the listed __init__s export none
# (the ``ops/*_pallas.py`` modules are imported where they are used, and
# their port counterparts are the kernel wrappers in ``ops/``)
PALLAS_ONLY = {"downbeats_pallas", "novelty_pallas", "polyphase_pallas", "viterbi_pallas"}


def _default(value):
    """A default as a comparable value: a config or capacities dataclass by
    its fields, an enum member by its value (each package has its own
    classes)."""
    if dataclasses.is_dataclass(value):
        return {k: getattr(v, "value", v) for k, v in dataclasses.asdict(value).items()}
    return value


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_take_the_jax_parameters(name):
    want = inspect.signature(getattr(janalysis, name)).parameters
    got = inspect.signature(getattr(panalysis, name)).parameters
    shared = [p for p in got.values() if p.name not in PORT_ONLY[name]]
    assert [p.name for p in shared] == list(want), name
    for p in shared:
        w = want[p.name]
        assert p.kind == w.kind, (name, p.name, p.kind, w.kind)
        assert _default(p.default) == _default(w.default), (name, p.name)
    for p in got.values():
        if p.name in PORT_ONLY[name]:
            assert p.kind == inspect.Parameter.KEYWORD_ONLY, (name, p.name)
    assert {p.name for p in got.values()} - set(want) == PORT_ONLY[name]


@pytest.mark.parametrize("name", PARALLEL_FUNCTIONS)
def test_parallel_functions_take_the_jax_parameters(name):
    module, fn = name.split(".")
    want = inspect.signature(getattr(importlib.import_module(f"stratum_dsp_tpu.parallel.{module}"),
                                     fn)).parameters
    got = inspect.signature(getattr(importlib.import_module(
        f"stratum_dsp_tpu_torch.parallel.{module}"), fn)).parameters
    assert list(got) == list(want), name
    for p in got.values():
        assert p.kind == want[p.name].kind, (name, p.name)
        assert p.default == want[p.name].default, (name, p.name)


def test_jit_and_perturb_are_accepted_in_their_places():
    import numpy as np
    import stratum_dsp_tpu_torch as port
    from stratum_dsp_tpu_torch import testing

    x = testing.kick_patterns([120.0], 3.0).numpy()
    caps = port.PipelineCaps(max_onsets=128, max_beats=64, seg_beat_cap=16, max_segments=4)
    n = np.asarray([x.shape[1]])
    a = port.analyze_batch(x, n, port.SLICE_CONFIG, 44100, caps, False, device="cpu")
    b = port.analyze_batch(x, n, port.SLICE_CONFIG, 44100, caps, True, device="cpu")
    assert float(a["bpm"][0]) == float(b["bpm"][0]) and bool(a["ok"][0])
    t = port.stage_timings(x, n, port.SLICE_CONFIG, 44100, caps, 1, False, device="cpu")
    assert t["full"] > 0.0
    with pytest.raises(TypeError):
        port.analyze_batch(x, n, port.SLICE_CONFIG, 44100, caps, True, "cpu")


def _exported(module) -> list:
    """The public names a JAX ``__init__`` binds by its own statements (its
    imports and definitions, read from its source: a submodule that other
    code imports later also becomes an attribute of the package)."""
    tree = ast.parse(Path(module.__file__).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {a.asname or a.name.split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return sorted(n for n in names if not n.startswith("_") and n != "annotations")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(sub):
    jmod = importlib.import_module(f"stratum_dsp_tpu.{sub}")
    pmod = importlib.import_module(f"stratum_dsp_tpu_torch.{sub}")
    names = _exported(jmod)
    assert not set(names) & PALLAS_ONLY, sub
    assert names or sub == "features", sub
    missing = []
    for name in names:
        try:
            exec(f"from stratum_dsp_tpu_torch.{sub} import {name}", {})
        except ImportError:
            missing.append(name)
    assert not missing, (sub, missing)
    # a submodule the JAX __init__ exports is the port's twin of it
    for name in names:
        if inspect.ismodule(getattr(jmod, name)):
            assert getattr(pmod, name).__name__ == f"stratum_dsp_tpu_torch.{sub}.{name}"


def test_every_jax_subpackage_is_listed_or_left_out_with_a_reason():
    import pkgutil

    import stratum_dsp_tpu

    found = {m.name.removeprefix("stratum_dsp_tpu.") for m in
             pkgutil.walk_packages(stratum_dsp_tpu.__path__, "stratum_dsp_tpu.") if m.ispkg}
    assert found - set(SUBPACKAGES) == {"cli"}  # cli's __init__ is empty


@pytest.mark.parametrize("call", ["OnnxModel.load", "OnnxModel.infer", "MlRefinement.refine_bpm",
                                  "MlRefinement.refine_key"])
def test_ml_stubs_raise_as_the_jax_ones_do(call):
    """The Phase-2 ML placeholders raise the same error, each package its
    own ``errors.NotImplementedYet``, with the same message; the edge-case
    detector finds nothing in both."""
    from stratum_dsp_tpu import errors as jerrors
    from stratum_dsp_tpu import ml as jml

    from stratum_dsp_tpu_torch import errors as perrors
    from stratum_dsp_tpu_torch import ml as pml

    cls, method = call.split(".")
    messages = []
    for ml, err in ((jml, jerrors.NotImplementedYet), (pml, perrors.NotImplementedYet)):
        target = getattr(ml, cls).load if method == "load" else getattr(
            getattr(ml, cls)("model.onnx") if cls == "OnnxModel" else getattr(ml, cls)(), method)
        with pytest.raises(err) as exc:
            target("model.onnx") if method == "load" else target({})
        messages.append(str(exc.value))
    assert messages[0] == messages[1]
    assert pml.detect_edge_cases({}) == jml.detect_edge_cases({}) == []
    assert pml.OnnxModel("m.onnx").path == "m.onnx"


SCRIPT = r"""
import sys
sys.path.insert(0, {repo!r})
import importlib, pkgutil, subprocess
calls = []
real = subprocess.Popen
def spy(*a, **k):
    calls.append(a[0] if a else k.get("args"))
    return real(*a, **k)
subprocess.Popen = spy
import stratum_dsp_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, "stratum_dsp_tpu_torch."):
    importlib.import_module(m.name)
from stratum_dsp_tpu_torch.ops import cuda_build
from stratum_dsp_tpu_torch.io import decode
assert cuda_build.library.cache_info().misses == 0, "a kernel library was loaded"
assert decode.native_lib.cache_info().misses == 0, "the decoder library was loaded"
assert not calls, calls
print("built nothing")
"""


def test_importing_the_port_builds_nothing():
    proc = subprocess.run([sys.executable, "-c", SCRIPT.format(repo=str(REPO))],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip() == "built nothing"
