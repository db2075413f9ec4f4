"""Set-up's seconds in the program's stores: its ``store.build`` spans
(the train and the test store: the host's compact columns and their
upload), summed."""

from metrics import _spans


def read(r):
    return _spans.seconds_of(r, "store.build")
