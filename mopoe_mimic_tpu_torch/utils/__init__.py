"""Utilities of the training CLI: failure types, logging, the run
directory, metric meters, the results CSV, TensorBoard, checkpoints,
preemption and profiling."""
