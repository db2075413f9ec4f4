"""The training step's share of the card's bf16 peak in a DenseNet cell: the
operations its step needs (``_work_densenet.train_step_ops``: both trunks,
``proj``, the compressors, the image decoders at the configuration's size
and the text networks) over the window's time a step
(``epoch.ms_per_step``) and 989 TFLOP/s (NVIDIA's H100 SXM data sheet,
dense, at 700 W; the card's power limit is in the run's record)."""

from metrics import _work, _work_densenet


def read(r):
    n = r.get("window_epochs")
    if not n:
        return None
    step_s = sum(r["train_s"]) / (n * r["steps_per_epoch"])
    ops = _work_densenet.train_step_ops(r["config"])
    return 100.0 * ops / step_s / _work.PEAK_BF16_OPS_PER_S
