"""Simple stdout + file logger.

Copy of ``strive_tpu/utils/logger.py`` (reference ``utils/logger.py:7-33``),
plus ``silent``.
"""

from __future__ import annotations

import datetime
import os


class Logger:
    log_file = None
    silent = False  # set on the ranks other than 0 of a multi-process run

    @staticmethod
    def init(log_path):
        if Logger.silent:
            return
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        Logger.log_file = log_path
        with open(log_path, "w") as f:
            f.write("Log created %s\n" % datetime.datetime.now().isoformat())

    @staticmethod
    def log(msg):
        if Logger.silent:
            return
        msg = str(msg)
        print(msg, flush=True)
        if Logger.log_file is not None:
            with open(Logger.log_file, "a") as f:
                f.write(msg + "\n")


def throw_err(msg):
    Logger.log("ERROR: %s" % msg)
    raise RuntimeError(msg)


def mkdir(path):
    os.makedirs(path, exist_ok=True)
