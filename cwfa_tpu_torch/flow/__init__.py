"""cwfa_tpu_torch.flow — see the package docstring."""
