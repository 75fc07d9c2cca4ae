"""cwfa_tpu_torch.engine — see the package docstring."""
