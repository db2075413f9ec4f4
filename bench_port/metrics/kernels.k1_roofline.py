"""K1's share of its roofline: the least time of the subset product of
experts' forward and backward (``_work.k1_bound_seconds``) over their
device time a replayed training step (the ``poe_subsets`` kernels of the
profiled epoch's train pass)."""

from metrics import _profiled, _work


def read(r):
    ms = _profiled.ms_per_step(r, lambda n: n.startswith("poe_subsets"))
    if ms is None:
        return None
    return 100.0 * _work.k1_bound_seconds(r["config"]) * 1e3 / ms
