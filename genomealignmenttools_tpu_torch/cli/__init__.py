"""Command surface of the port (counterpart of genomealignmenttools_tpu/cli/):
python -m genomealignmenttools_tpu_torch.cli.main <command> ..."""
