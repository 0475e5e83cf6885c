"""Event hooks for experiment lifecycles (isca/__init__.py:50-82 equivalent).

Port of isca_tpu/utils/events.py, unchanged: plain Python.

The reference's `EventEmitter` lets users attach callbacks to run lifecycle
events ('run:ready', 'run:output', 'run:complete', 'run:failed' - emitted in
experiment.py:300-353) for e-mail alerts, progress bars and bookkeeping.
Same surface here; `Experiment` subclasses it.
"""

from __future__ import annotations

from collections import defaultdict


class EventEmitter:
    def __init__(self):
        self._events: dict[str, list] = defaultdict(list)

    def on(self, event: str, fn=None):
        """Register a callback; usable as a decorator: @exp.on('run:complete')."""
        if fn is None:
            def deco(f):
                self._events[event].append(f)
                return f
            return deco
        self._events[event].append(fn)
        return fn

    def emit(self, event: str, *args, **kwargs) -> bool:
        handlers = self._events.get(event, [])
        for fn in list(handlers):
            fn(*args, **kwargs)
        return bool(handlers)


class FailedRunError(Exception):
    """A model segment failed (experiment.py:293-298 equivalent)."""
