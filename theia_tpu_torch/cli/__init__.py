"""The `theia` command line interface (python -m theia_tpu_torch.cli)."""
