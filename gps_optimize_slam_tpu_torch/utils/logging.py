"""Structured logging (SURVEY §5: the reference logs ~90 raw prints).

One shared logger with step-banner helpers used by the pipeline and the
command line; silent by default for library use, enabled by the command
line's ``-v`` or by ``enable(level)``.
"""

from __future__ import annotations

import logging

LOGGER_NAME = "gps_optimize_slam_tpu_torch"


def get_logger() -> logging.Logger:
    return logging.getLogger(LOGGER_NAME)


def enable(level: int = logging.INFO) -> None:
    logger = get_logger()
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(h)
    logger.setLevel(level)


def step(n: int, total: int, message: str) -> None:
    """Reference-style step banner (EKFGPSSLAM.py step prints) at INFO."""
    get_logger().info("step %d/%d: %s", n, total, message)
