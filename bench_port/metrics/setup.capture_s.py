"""Seconds in the graph captures: the program's ``scan.capture`` spans
(the train and the eval step's warm-up and capture), summed. In a sound
run they all fall in set-up; a capture in the window is a recapture, and
adds here."""

from metrics import _spans


def read(r):
    return _spans.seconds_of(r, "scan.capture")
