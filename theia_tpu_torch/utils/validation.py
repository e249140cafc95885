"""Shared input validation.

Re-provides the reference's validators: job-name/UUID parsing
(ParseRecommendationName / ParseADAlgorithmName, pkg/util/utils.go),
the Kubernetes resource-quantity check applied to driver/executor
core+memory CRD fields (pkg/controller/networkpolicyrecommendation/
controller.go:586-608), and the enum checks the CLI and the TAD
controller apply to --algo / --agg-flow
(pkg/theia/commands/anomaly_detection_run.go,
pkg/controller/anomalydetector/controller.go).
"""

from __future__ import annotations

import re
import uuid
from typing import Tuple

TAD_ALGOS = ("EWMA", "ARIMA", "DBSCAN")
AGG_FLOWS = ("", "pod", "external", "svc")
POLICY_TYPES = ("anp-deny-applied", "anp-deny-all", "k8s-np")

# Kubernetes quantity grammar: signed decimal + optional binary (Ki, Mi,
# ...) / decimal-SI (m, k, M, ..., E=exa) / scientific (e3, E-2) suffix.
# Exponent is tried first so '2e3' parses scientific while bare '12E'
# falls through to the exa suffix, matching K8s disambiguation.
_K8S_QUANTITY_RE = re.compile(
    r"^[+-]?(\d+|\d+\.\d*|\.\d+)"
    r"(Ki|Mi|Gi|Ti|Pi|Ei|[eE][+-]?\d+|[numkKMGTPE])?$")

_SUFFIX_MULTIPLIER = {
    "": 1.0,
    "n": 1e-9, "u": 1e-6, "m": 1e-3,
    "k": 1e3, "K": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15,
    "E": 1e18,
    "Ki": 2.0 ** 10, "Mi": 2.0 ** 20, "Gi": 2.0 ** 30,
    "Ti": 2.0 ** 40, "Pi": 2.0 ** 50, "Ei": 2.0 ** 60,
}


def parse_k8s_quantity(value: str) -> float:
    """'512M' → 512e6, '200m' → 0.2, '1Gi' → 2**30. Raises ValueError
    on anything the K8s quantity grammar rejects."""
    m = _K8S_QUANTITY_RE.match(value.strip())
    if not m:
        raise ValueError(f"invalid resource quantity {value!r}")
    number, suffix = m.group(1), m.group(2) or ""
    if suffix[:1] in ("e", "E") and suffix[1:].lstrip("+-").isdigit():
        return float(number) * 10.0 ** int(suffix[1:])
    return float(number) * _SUFFIX_MULTIPLIER[suffix]


def validate_k8s_quantity(value: str, flag: str) -> str:
    try:
        parse_k8s_quantity(value)
    except ValueError:
        raise ValueError(
            f"{flag} should conform to the Kubernetes resource "
            f"quantity convention (e.g. 200m, 512M, 1Gi): got "
            f"{value!r}")
    return value


def validate_algo(algo: str) -> str:
    if algo not in TAD_ALGOS:
        raise ValueError(
            f"invalid algo {algo!r}: must be one of "
            f"{', '.join(TAD_ALGOS)}")
    return algo


def validate_agg_flow(agg_flow: str) -> str:
    if agg_flow not in AGG_FLOWS:
        raise ValueError(
            f"invalid agg-flow {agg_flow!r}: must be one of "
            f"pod, external, svc")
    return agg_flow


def validate_policy_type(policy_type: str) -> str:
    if policy_type not in POLICY_TYPES:
        raise ValueError(
            f"invalid policyType {policy_type!r}: must be one of "
            f"{', '.join(POLICY_TYPES)}")
    return policy_type


def parse_job_name(name: str, prefix: str) -> str:
    """'pr-<uuid>' → '<uuid>' with UUID validation; raises ValueError
    like the reference's ParseRecommendationName."""
    if not name.startswith(prefix):
        raise ValueError(
            f"invalid job name {name!r}: expected prefix {prefix!r}")
    suffix = name[len(prefix):]
    try:
        uuid.UUID(suffix)
    except ValueError:
        raise ValueError(
            f"invalid job name {name!r}: {suffix!r} is not a UUID")
    return suffix


def split_job_name(name: str) -> Tuple[str, str]:
    """'pr-<uuid>' → ('pr', '<uuid>'); accepts any known prefix."""
    for prefix, kind in (("pr-", "pr"), ("tad-", "tad"), ("dd-", "dd"),
                         ("fpm-", "fpm"), ("sad-", "sad")):
        if name.startswith(prefix):
            return kind, parse_job_name(name, prefix)
    raise ValueError(f"unrecognized job name {name!r}")
