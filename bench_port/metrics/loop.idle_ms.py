"""The device's idle milliseconds in the profiled epoch that fall inside
the loop's own host work: the program's spans of that epoch other than
the epoch, its passes and the replays' enqueue (``_spans.OUTSIDE_LOOP``),
that is the index matrices and their upload, the reads, the NaN checks,
TensorBoard, the callbacks with the checkpoint staging, the CSV and the
guard read; the gaps between the graph's kernels while the device works
through a pass (``_spans``, the device's backlog) left out. The spans are
placed on the profiler's clock by the train pass's replays
(``_spans.profiled_epoch``)."""

from metrics import _spans


def read(r):
    epoch = _spans.profiled_epoch(r)
    return None if epoch is None else _spans.loop_idle_us(epoch) / 1e3
