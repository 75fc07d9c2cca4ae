"""cwfa_tpu_torch.models — see the package docstring."""
