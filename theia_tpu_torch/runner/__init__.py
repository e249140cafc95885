"""The job runner (`python -m theia_tpu_torch.runner`, the Spark-job CLI
contract) and its progress reporting."""

from .progress import NPR_STAGES, TAD_STAGES, JobProgress

__all__ = ["JobProgress", "TAD_STAGES", "NPR_STAGES"]
