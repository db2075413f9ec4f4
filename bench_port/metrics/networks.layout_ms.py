"""The NCHW ↔ NHWC transposes' device milliseconds a replayed training
step (cuDNN's ``nchwToNhwc`` and ``nhwcToNchw`` kernels), over the
profiled epoch's train pass."""

from metrics import _profiled


def read(r):
    return _profiled.ms_per_step(r, lambda n: n.startswith(("nchwToNhwc", "nhwcToNchw")))
