"""Command-line entry points of the port (`python -m ais_tpu_torch.cli.ais_rx`)."""
