"""Preemption-safe training: catch SIGTERM, checkpoint, exit clean
(mopoe_mimic_tpu/utils/preemption.py).

Batch schedulers deliver SIGTERM shortly before evicting a worker. The
reference has no preemption story (SURVEY.md §5). ``train/loop.run_epochs``
reads a ``PreemptionGuard`` at every epoch boundary, force-saves the whole
train state through the checkpoint manager and returns with
``preempted=True``; the next launch resumes from that checkpoint
(``--load_run``). In one process the flag is read as a plain bool; the
agreement of several processes on it is not ported (the loop raises where
a ``torch.distributed`` group of more than one process is up).

The guard chains any previously installed handler, degrades gracefully
off the main thread (Python only allows signal.signal there), and is
injectable so tests, or frameworks embedding the loop, can trigger the
same code path programmatically with ``guard.request()``.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional, Sequence

from mopoe_mimic_tpu_torch.utils.logger import log


class PreemptionGuard:
    """Latched "stop soon" flag, optionally wired to OS signals.

    Usage::

        with PreemptionGuard().install() as guard:
            for epoch in ...:
                ...
                if guard.requested:
                    save_and_exit()
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._previous: dict = {}
        self._installed = False

    # -- flag -----------------------------------------------------------

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self, signum: Optional[int] = None, frame=None) -> None:
        """Signal-handler signature; also the programmatic trigger."""
        if not self._event.is_set():
            name = (
                signal.Signals(signum).name if signum is not None else "request()"
            )
            log.warning(
                f"preemption notice ({name}): will checkpoint and exit at "
                "the next epoch boundary"
            )
        self._event.set()
        prev = self._previous.get(signum)
        if callable(prev):  # chain whatever was installed before us
            prev(signum, frame)

    # -- OS wiring ------------------------------------------------------

    def install(self) -> "PreemptionGuard":
        """Register the signal handlers (main thread only — elsewhere the
        guard still works via request())."""
        try:
            for sig in self._signals:
                self._previous[sig] = signal.signal(sig, self.request)
            self._installed = True
        except ValueError:  # not the main thread
            log.warning(
                "PreemptionGuard: not on the main thread — OS signals not "
                "hooked; programmatic request() still works"
            )
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
            except (ValueError, TypeError):
                pass
        self._previous.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()
