"""Command-line entry of the torch port (`python -m mvropose_torch.cli`)."""
