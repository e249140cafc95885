"""Synthetic flow generator (a copy of theia_tpu/data/synth.py)."""
