"""Control plane: job controllers + aggregated REST API (ports
theia_tpu/manager)."""

from .api import API_PORT, TheiaManagerServer
from .jobs import (
    KIND_DD,
    KIND_FPM,
    KIND_NPR,
    KIND_SPATIAL,
    KIND_TAD,
    STATE_COMPLETED,
    STATE_FAILED,
    STATE_NEW,
    STATE_RUNNING,
    STATE_SCHEDULED,
    JobController,
    JobRecord,
    job_id_from_name,
)
from .stats import StatsProvider

__all__ = [
    "API_PORT", "TheiaManagerServer",
    "JobController", "JobRecord", "job_id_from_name",
    "KIND_NPR", "KIND_TAD", "KIND_DD", "KIND_FPM", "KIND_SPATIAL",
    "STATE_NEW", "STATE_SCHEDULED", "STATE_RUNNING", "STATE_COMPLETED",
    "STATE_FAILED",
    "StatsProvider",
]
