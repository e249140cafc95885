"""The job runner's shared piece: progress reporting (progress.py).
The runner itself, the controller's subprocess dispatch, is not ported
yet: ROADMAP A17."""

from .progress import NPR_STAGES, TAD_STAGES, JobProgress

__all__ = ["JobProgress", "TAD_STAGES", "NPR_STAGES"]
