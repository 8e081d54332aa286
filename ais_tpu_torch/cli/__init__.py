"""Command-line entry points of the port (`python -m ais_tpu_torch.cli.<name>`):
`ais_rx`, `ais_scope`, `modem_bench`."""
