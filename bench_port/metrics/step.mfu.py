"""The training step's share of the card's bf16 peak: the operations the
configuration's step needs (``_work.train_step_ops``) over the window's
time a step (``epoch.ms_per_step``) and 989 TFLOP/s (NVIDIA's H100 SXM
data sheet, dense, at 700 W; the card's power limit is in the run's
record)."""

from metrics import _work


def read(r):
    n = r.get("window_epochs")
    if not n:
        return None
    step_s = sum(r["train_s"]) / (n * r["steps_per_epoch"])
    return 100.0 * _work.train_step_ops(r["config"]) / step_s / _work.PEAK_BF16_OPS_PER_S
