"""Concurrency tooling the port needs: the `lockdep` named-lock
factory (a copy of theia_tpu/analysis/lockdep.py)."""
