"""Run logger: console plus an optional file (counterpart of ``Logger`` in
``arcnerf_tpu/utils/logger.py``; one process, so no rank gating)."""

import logging
import os
import sys


class Logger:

    def __init__(self, path=None, name="arcnerf_torch"):
        self._logger = logging.getLogger(name)
        self._logger.setLevel(logging.INFO)
        for handler in self._logger.handlers:
            handler.close()
        self._logger.handlers = []
        fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s")
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        self._logger.addHandler(sh)
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            self._logger.addHandler(fh)

    def add_log(self, msg, level="info"):
        getattr(self._logger, level)(msg)
