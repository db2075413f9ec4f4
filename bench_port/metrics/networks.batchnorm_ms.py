"""BatchNorm's device milliseconds a replayed training step: the kernels
of ATen's and cuDNN's BatchNorm (names with ``batch_norm``, ``batchnorm``
or cuDNN's ``bn_``), over the profiled epoch's train pass."""

from metrics import _profiled

NAMES = ("batch_norm", "batchnorm", "bn_")


def read(r):
    return _profiled.ms_per_step(r, lambda n: any(k in n.lower() for k in NAMES))
