"""Beat tracking: HMM Viterbi, Bayesian drift refinement, time signature,
downbeats, grid stability (reference ``src/features/beat_tracking/``)."""

from .hmm import BeatTensor, track_beats
from .variation import refine_beats
from .time_signature import detect_time_signature
from .grid import BeatGridTensor, generate_beat_grid
