"""Analysis orchestration of the plain reference: the batched pipeline and
host-side result decoding."""
