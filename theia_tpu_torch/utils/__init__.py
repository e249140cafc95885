"""Shared helpers (copies of theia_tpu/utils modules): env config,
leveled logging, fault hooks."""

from .env import env_float, env_int  # noqa: F401
from .faults import FaultError  # noqa: F401
from .logging import get_logger  # noqa: F401
