"""Shared helpers: leveled logging w/ support-bundle ring buffer,
input validation (job names, K8s quantities, algo enums), env config.
Reference: pkg/util/ (utils.go, env/env.go) and klog usage throughout.
"""

from .atomic import atomic_write  # noqa: F401
from .faults import FaultError  # noqa: F401
from .env import (  # noqa: F401
    DEFAULT_NAMESPACE,
    env_float,
    env_int,
    get_manager_addr,
    get_theia_namespace,
)
from .logging import (  # noqa: F401
    Logger,
    clear_logs,
    dump_logs,
    get_logger,
    get_verbosity,
    set_verbosity,
)
from .validation import (  # noqa: F401
    AGG_FLOWS,
    POLICY_TYPES,
    TAD_ALGOS,
    parse_job_name,
    parse_k8s_quantity,
    split_job_name,
    validate_agg_flow,
    validate_algo,
    validate_k8s_quantity,
    validate_policy_type,
)
