"""K2's share of its roofline: the least time of the word head's
log-probabilities and gradients (``_work.k2_bound_seconds``, bytes,
bf16 operations and the SFUs' exponentials at the card's maximum SM
clock) over the device time of the ``texthead_`` kernels a replayed
training step."""

from metrics import _profiled, _work


def read(r):
    if r["config"]["text_encoding"] != "word":
        return None
    ms = _profiled.ms_per_step(r, lambda n: n.startswith("texthead_"))
    if ms is None:
        return None
    clock = r.get("sm_clock_hz") or _work.DEFAULT_SM_CLOCK_HZ
    return 100.0 * _work.k2_bound_seconds(r["config"], clock) * 1e3 / ms
