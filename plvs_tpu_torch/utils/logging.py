"""Leveled logging to stderr and optional file sinks (a copy of
plvs_tpu/utils/logging.py)."""

from __future__ import annotations

import sys

QUIET = 0
NORMAL = 1
VERBOSE = 2
DEBUG = 3

_level = NORMAL
_sinks = [sys.stderr]


def set_level(level: int):
    global _level
    _level = level


def add_file_sink(path: str):
    _sinks.append(open(path, "a"))


def log(msg: str, level: int = NORMAL):
    if level <= _level:
        for s in _sinks:
            print(msg, file=s)
            s.flush()


def debug(msg: str):
    log(msg, DEBUG)


def verbose(msg: str):
    log(msg, VERBOSE)
