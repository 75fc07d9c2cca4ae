"""cwfa_tpu_torch.cli — the command-line entry points of the port
(``python -m cwfa_tpu_torch.cli.serve``)."""
