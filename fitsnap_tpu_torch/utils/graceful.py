"""Graceful SIGINT/SIGTERM handling for long-running fits.

Single-process analog of the reference's ``GracefulKiller`` + ``pt.abort``
(fitsnap3lib/parallel_tools.py:74-92, 840-860): the first signal requests a
clean stop at the next pipeline-stage boundary (so finished work — scraped
configs, computed descriptors, a completed fit — can still be written out);
a second signal aborts immediately.  There is no MPI world to ``Abort()``
here — a fit is one Python process — so "abort" is a plain exit after
restoring the default handlers.
"""

import os
import signal
import sys


class GracefulStop:
    """Context manager trapping SIGINT/SIGTERM during a fit pipeline.

    Usage::

        with GracefulStop() as stop:
            for stage in stages:
                stage()
                if stop:           # truthy once a signal arrived
                    break
    """

    def __init__(self, screen=print):
        self.requested = False
        self._screen = screen
        self._prev = {}

    def _handler(self, signum, frame):
        if self.requested:  # second signal: hard abort
            self._screen(f"second signal {signal.Signals(signum).name}: "
                         "aborting now")
            self._restore()
            sys.exit(128 + signum)
        self.requested = True
        self._screen(f"caught {signal.Signals(signum).name}: finishing the "
                     "current stage, then stopping (signal again to abort)")

    def _restore(self):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass

    def __enter__(self):
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:
                # not the main thread (library mode inside a worker):
                # signals stay with the host application
                pass
        return self

    def __exit__(self, *exc):
        self._restore()
        return False

    def __bool__(self):
        return self.requested
