"""Accuracy validation for the port: key and beat-grid scoring, the ID3 tag
reader, the batch runner over a ground-truth CSV (``run_validation``), the
synthetic battery runner (``run_battery``) and the tempogram tuning grid
sweep over a CSV (``sweep_tempogram_tuning``); the port's copies of the
repository's ``validation/`` modules, over the port's own pipeline."""
