"""Singleton logger with level-specific formats.

Copy of ``remora_tpu/log.py`` (reference ``src/remora/log.py``) under
its own logger name, so both packages can log from one process: a single
"RemoraTPUTorch" logger, terse console INFO format, verbose (process/thread/
module/line) format at WARNING+ and for the optional DEBUG file handler.
"""

import logging
import sys

_LOGGER_NAME = "RemoraTPUTorch"

_TERSE_FMT = "[%(asctime)s] %(message)s"
_VERBOSE_FMT = (
    "[%(asctime)s:%(processName)s:%(threadName)s:%(module)s:%(lineno)d] "
    "%(levelname)s: %(message)s"
)


class LevelFormatter(logging.Formatter):
    def __init__(self):
        super().__init__()
        self._terse = logging.Formatter(_TERSE_FMT, "%H:%M:%S")
        self._verbose = logging.Formatter(_VERBOSE_FMT, "%H:%M:%S")

    def format(self, record):
        if record.levelno >= logging.WARNING or record.levelno <= logging.DEBUG:
            return self._verbose.format(record)
        return self._terse.format(record)


def get_logger(module_name=""):
    return logging.getLogger(_LOGGER_NAME)


_CONSOLE = logging.StreamHandler(sys.stderr)
_CONSOLE.setLevel(logging.INFO)
_CONSOLE.setFormatter(LevelFormatter())


def init_logger(log_fn=None, quiet=False):
    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(logging.DEBUG)
    if quiet:
        _CONSOLE.setLevel(logging.WARNING)
    if _CONSOLE not in logger.handlers:
        logger.addHandler(_CONSOLE)
    if log_fn is not None:
        fh = logging.FileHandler(log_fn, "w")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(_VERBOSE_FMT, "%H:%M:%S"))
        logger.addHandler(fh)
    logger.debug(f'Command: """{" ".join(sys.argv)}"""')
    return logger


# always attach console handler so library users see INFO messages
logging.getLogger(_LOGGER_NAME).addHandler(_CONSOLE)
logging.getLogger(_LOGGER_NAME).setLevel(logging.DEBUG)
