"""Milliseconds a training step: the window epochs' train seconds from
``run_epochs``' history (each pass ends in the epoch's one read of the
device) over their steps."""


def read(r):
    n = r.get("window_epochs")
    if not n:
        return None
    return sum(r["train_s"]) / (n * r["steps_per_epoch"]) * 1e3
