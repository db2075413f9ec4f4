"""The dense layers' concatenations' device milliseconds a replayed
training step: ATen's ``torch.cat`` kernels (``CONCAT_KERNEL`` at the start
of the name), over the profiled epoch's train pass."""

from metrics import _profiled, _work_densenet


def read(r):
    return _profiled.ms_per_step(r, lambda n: n.startswith(_work_densenet.CONCAT_KERNEL))
