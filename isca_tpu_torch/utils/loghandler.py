"""Colored logging + run progress reporting.

Port of isca_tpu/utils/loghandler.py; the package logger is
"isca_tpu_torch". It replaces the reference's `isca/loghandler.py`
(ANSI-colored logger whose records carry the experiment name) and `isca/util.py:25-48 exp_progress`
(a tqdm progress bar fed by scraping the Fortran month/day stdout).  Here
progress comes from the Experiment's 'run:progress' events instead of
stdout scraping, so the bar also shows live model-days/day.
"""

from __future__ import annotations

import logging
import sys
import time

COLORS = {
    "DEBUG": "\033[36m",     # cyan
    "INFO": "\033[32m",      # green
    "WARNING": "\033[33m",   # yellow
    "ERROR": "\033[31m",     # red
    "CRITICAL": "\033[1;31m",
}
RESET = "\033[0m"


class ColoredFormatter(logging.Formatter):
    """loghandler.py equivalent: level-colored records, optional exp name."""

    def __init__(self, use_color: bool | None = None):
        super().__init__("%(asctime)s %(name)s %(levelname)s: %(message)s",
                         datefmt="%H:%M:%S")
        self.use_color = (sys.stderr.isatty() if use_color is None else use_color)

    def format(self, record):
        msg = super().format(record)
        if self.use_color and record.levelname in COLORS:
            return f"{COLORS[record.levelname]}{msg}{RESET}"
        return msg


def enable_colored_logging(logger_name: str = "isca_tpu_torch",
                           level: int = logging.INFO) -> logging.Logger:
    """Attach a colored stream handler to the package logger (idempotent)."""
    log = logging.getLogger(logger_name)
    for h in log.handlers:
        if isinstance(getattr(h, "formatter", None), ColoredFormatter):
            return log
    h = logging.StreamHandler()
    h.setFormatter(ColoredFormatter())
    log.addHandler(h)
    log.setLevel(level)
    return log


class exp_progress:
    """Progress reporting for Experiment.run via 'run:progress' events.

    Usage (mirrors the reference's `with exp_progress(exp): exp.run(i)`):

        with exp_progress(exp, description="spinup"):
            exp.run(1, days=30)

    Uses tqdm when importable, else prints a line per update to stderr.
    """

    def __init__(self, exp, description: str | None = None, out=sys.stderr):
        self.exp = exp
        self.description = description or getattr(exp, "name", "run")
        self.out = out
        self._bar = None
        self._t0 = None
        self._last_day = 0.0

    def _on_progress(self, exp, i, time_days):
        now = time.time()
        rate = ((time_days - self._day0) * 86400.0 / max(now - self._t0, 1e-9))
        if self._bar is not None:
            self._bar.update(time_days - self._last_day)
            self._bar.set_postfix_str(f"{rate:.0f} model-days/day")
        else:
            self.out.write(
                f"\r{self.description}: segment {i} day {time_days:.2f} "
                f"({rate:.0f} model-days/day)")
            self.out.flush()
        self._last_day = time_days

    def __enter__(self):
        try:
            from tqdm import tqdm
            self._bar = tqdm(desc=self.description, unit=" days", total=None)
        except ImportError:
            self._bar = None
        self._t0 = time.time()
        self._day0 = None

        def handler(exp, i, time_days):
            if self._day0 is None:
                # first event: measure rate from here (skips compile time)
                self._day0 = time_days
                self._t0 = time.time()
                self._last_day = time_days
                return
            self._on_progress(exp, i, time_days)

        self._handler = handler
        self.exp.on("run:progress", handler)
        return self

    def __exit__(self, *exc):
        if self._bar is not None:
            self._bar.close()
        elif self._last_day:
            self.out.write("\n")
        handlers = self.exp._events.get("run:progress", [])
        if self._handler in handlers:
            handlers.remove(self._handler)
        return False
