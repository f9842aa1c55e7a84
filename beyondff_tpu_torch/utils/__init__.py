"""IO, resume checkpoints and profiling."""
