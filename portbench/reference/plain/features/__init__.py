"""Feature extraction: onsets, periodicity (BPM), chroma, key, beat tracking."""
