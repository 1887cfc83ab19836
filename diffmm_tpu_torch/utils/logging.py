"""Logging with the reference's message surface (reference `Utils/Log.py:7-40`),
as in ``diffmm_tpu/utils/logging.py``: one shared timestamped file handler
(``logs/<ts>_<ds>.log``) plus stdout, single ``.info`` level,
``'%m/%d %H:%M:%S - message'`` format."""

from __future__ import annotations

import logging
import os
import sys
from datetime import datetime


class Log:
    _shared_file_handler: logging.FileHandler | None = None

    def __init__(self, log_name: str, file_name: str | None = None, log_dir: str = "logs"):
        self.logger = logging.getLogger(f"diffmm_tpu_torch.{log_name}")
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        os.makedirs(log_dir, exist_ok=True)

        if Log._shared_file_handler is None:
            ts = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
            Log._shared_file_handler = logging.FileHandler(
                os.path.join(log_dir, f"{ts}_{file_name or 'shared'}.log")
            )
            Log._shared_file_handler.setFormatter(
                logging.Formatter("%(asctime)s - %(message)s", datefmt="%m/%d %H:%M:%S")
            )
        if Log._shared_file_handler not in self.logger.handlers:
            self.logger.addHandler(Log._shared_file_handler)

        if not any(isinstance(h, logging.StreamHandler) and h.stream is sys.stdout
                   for h in self.logger.handlers):
            console = logging.StreamHandler(sys.stdout)
            console.setFormatter(
                logging.Formatter("%(asctime)s - %(message)s", datefmt="%m/%d %H:%M:%S")
            )
            self.logger.addHandler(console)

    def info(self, message: str) -> None:
        self.logger.info(message)


class NullLog:
    """A log that writes nothing: every rank of a mesh but rank 0 takes one,
    so the run's lines and its log file come from rank 0 alone."""

    def info(self, message: str) -> None:
        pass
