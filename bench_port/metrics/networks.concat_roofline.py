"""The concatenations' share of their roofline: the bytes they read and
write a training step (the program's counter ``densenet.concat_bytes`` a
replayed step, read by the ``train_densenet`` driver) at the HBM's 3.35 TB/s
over their device time a step (``networks.concat_ms``)."""

from metrics import _profiled, _work, _work_densenet


def read(r):
    moved = (r.get("densenet_counts") or {}).get("densenet.concat_bytes")
    ms = _profiled.ms_per_step(r, lambda n: n.startswith(_work_densenet.CONCAT_KERNEL))
    if not moved or ms is None:
        return None
    return 100.0 * moved / _work.HBM_BYTES_PER_S * 1e3 / ms
