"""Engine logging: console + ``Syzygy.log`` file sink.

Port of ``syzygy_tpu/utils/log.py`` (``Logger::initLogging``,
``core/log.cpp:16-35``): two sinks, each message flushed as it is
written, the level set at init.
"""

from __future__ import annotations

import logging


class _FlushingFileHandler(logging.FileHandler):
    def emit(self, record):
        super().emit(record)
        self.flush()


def init_logging(level: int = logging.INFO, log_file: str = "Syzygy.log") -> logging.Logger:
    """Set up the engine's ``syzygy`` logger once and return it."""
    logger = logging.getLogger("syzygy")
    logger.setLevel(level)
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s")
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    logger.addHandler(console)
    try:
        file_handler = _FlushingFileHandler(log_file)
    except OSError:
        logger.warning("could not open %s for logging", log_file)
    else:
        file_handler.setFormatter(fmt)
        logger.addHandler(file_handler)
    return logger
