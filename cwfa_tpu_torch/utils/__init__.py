"""cwfa_tpu_torch.utils — host-side helpers (projections, PNG, TensorBoard
events, plots, seeding); see the package docstring."""
