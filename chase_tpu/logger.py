"""Leveled, category-filtered logger.

Analogue of the reference's ``algorithm/logger.hpp`` (ChaseLogger singleton:
5 levels, rank filter, category filter, env-configured via CHASE_LOG_LEVEL /
CHASE_LOG_RANK / CHASE_LOG_CATEGORIES).  Here "rank" maps to the JAX
process index for multi-host runs.
"""

from __future__ import annotations

import os
import sys
import time

__all__ = ["get_logger", "ChaseLogger", "LEVELS"]

LEVELS = {"error": 0, "warn": 1, "info": 2, "debug": 3, "trace": 4}


class ChaseLogger:
    def __init__(self):
        lvl = os.environ.get("CHASE_LOG_LEVEL", "warn").lower()
        self.level = LEVELS.get(lvl, 1)
        self.rank_filter = os.environ.get("CHASE_LOG_RANK")
        cats = os.environ.get("CHASE_LOG_CATEGORIES")
        self.categories = set(c.strip() for c in cats.split(",")) if cats else None
        self._t0 = time.perf_counter()

    def _rank(self) -> int:
        try:
            import jax
            return jax.process_index()
        except Exception:
            return 0

    def log(self, level: str, msg: str, category: str = "algorithm"):
        if LEVELS.get(level, 0) > self.level:
            return
        if self.categories is not None and category not in self.categories:
            return
        rank = self._rank()
        if self.rank_filter is not None and int(self.rank_filter) != rank:
            return
        dt = time.perf_counter() - self._t0
        print(f"[chase_tpu {level:5s} r{rank} {dt:9.3f}s {category}] {msg}",
              file=sys.stderr, flush=True)

    def error(self, msg, category="algorithm"):
        self.log("error", msg, category)

    def warn(self, msg, category="algorithm"):
        self.log("warn", msg, category)

    def info(self, msg, category="algorithm"):
        self.log("info", msg, category)

    def debug(self, msg, category="algorithm"):
        self.log("debug", msg, category)

    def trace(self, msg, category="algorithm"):
        self.log("trace", msg, category)


_logger = None


def get_logger() -> ChaseLogger:
    global _logger
    if _logger is None:
        _logger = ChaseLogger()
    return _logger
