"""Core numeric ops: streaming STFT, masked-tensor helpers, and the plain
versions of the CUDA kernels."""

from . import masked
from .stft import stft_reduce, hann_window, extract_frames, num_frames
