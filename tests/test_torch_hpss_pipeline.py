"""The percussive fallback through the whole pipeline (the tempogram of the
HPSS percussive part, for ambiguous tracks in the 55-80 BPM trap), the port on
the CPU against the JAX package under the port's output contract
(``tests/torch_port_reference.py``). Kicks at 75, 120 and 172 BPM: the 75 BPM
kick is ambiguous and in the low trap, so the fallback is needed on that row
and on no other. (The HPSS onset detector's pipeline test is in
``tests/test_torch_hpss.py``: each is one long compile on the JAX side.)"""

import torch

from torch_port_reference import run_both

torch.set_num_threads(2)
NO_ESCALATION = {"enable_tempogram_multi_resolution": False}


def test_percussive_fallback_matches_jax():
    ref, got = run_both({**NO_ESCALATION, "enable_tempogram_percussive_fallback": True})
    for out in (ref, got):
        assert out["percussive_triggered"].tolist() == [True, False, False]
    assert (got["percussive_used"] == ref["percussive_used"]).all()


def test_percussive_flags_stay_false_without_the_fallback():
    _, got = run_both(NO_ESCALATION)
    assert not got["percussive_triggered"].any() and not got["percussive_used"].any()
