"""Rank-aware logging (the port's copy of `openvla_oft_tpu/utils/overwatch.py`,
reference `prismatic/overwatch/overwatch.py:47-147`).

INFO on rank 0, ERROR elsewhere, with `rank_zero_only`. The rank is
`torch.distributed.get_rank()` where a process group exists, else 0; it is
never read from the environment.
"""

from __future__ import annotations

import functools
import logging
import sys
from typing import Callable

_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s :: %(message)s"


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Overwatch:
    def __init__(self, name: str):
        self.logger = logging.getLogger(name)
        if not self.logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(_FORMAT, "%m/%d %H:%M:%S"))
            self.logger.addHandler(handler)
        self.logger.setLevel(logging.INFO if _rank() == 0 else logging.ERROR)
        self.logger.propagate = False

    def info(self, msg, *args, **kw):
        self.logger.info(msg, *args, **kw)

    def warning(self, msg, *args, **kw):
        self.logger.warning(msg, *args, **kw)

    def error(self, msg, *args, **kw):
        self.logger.error(msg, *args, **kw)

    def debug(self, msg, *args, **kw):
        self.logger.debug(msg, *args, **kw)

    @property
    def rank(self) -> int:
        return _rank()

    def is_rank_zero(self) -> bool:
        return _rank() == 0

    def rank_zero_only(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if self.is_rank_zero():
                return fn(*args, **kwargs)
            return None

        return wrapper


def initialize_overwatch(name: str) -> Overwatch:
    """Reference `initialize_overwatch` (overwatch.py:146-147)."""
    return Overwatch(name)
