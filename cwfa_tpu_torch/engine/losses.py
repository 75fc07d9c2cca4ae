"""Loss and metric functions of training (counterpart of
``cwfa_tpu/engine/losses.py``; reference losses.py:477-500, utils.py:380-394,
CWFA.py:935-946), in PyTorch, differentiable where they are losses."""

from __future__ import annotations

import torch


def weighted_mse_loss(output, target, ths_perc: float = 0.05):
    """MSE double-masked by the 5%-of-max support of BOTH prediction and GT
    (reference losses.py:477-500); divides by the full element count, as
    the reference does."""
    out_shift = output - output.min()
    tgt_shift = target - target.min()
    out_mask = (out_shift > out_shift.max() * ths_perc).to(output.dtype)
    tgt_mask = (tgt_shift > tgt_shift.max() * ths_perc).to(output.dtype)
    return ((output - target) ** 2 * out_mask * tgt_mask).mean()


def mse_loss(output, target):
    return ((output - target) ** 2).mean()


def l1_loss(output, target):
    return (output - target).abs().mean()


def poisson_ll_loss(output, target, eps: float = 1e-8):
    """'LL' first-step loss (CWFA.py:944): mean(pred' - gt' * log(eps +
    pred')) on min-shifted tensors."""
    p = output - output.min()
    g = target - target.min()
    return (p - g * torch.log(eps + p)).mean()


def recon_loss(kind: str, gt, pred):
    """The loss menu of --loss_func_first_step / --loss_func_reg
    (CWFA.py:935-955): L1 / L2 / wL2 as f(gt, pred); LL takes the
    prediction as the rate."""
    if kind == "L1":
        return l1_loss(gt, pred)
    if kind == "L2":
        return mse_loss(gt, pred)
    if kind == "wL2":
        return weighted_mse_loss(gt, pred)
    if kind == "LL":
        return poisson_ll_loss(pred, gt)
    raise ValueError(f"unknown loss {kind!r}")


def psnr(img1, img2, pixel_max: float = 1.0):
    """reference utils.py:380-394 with its mse == 0 special cases."""
    mse = ((img1 - img2) ** 2).mean()
    if mse == 0:
        return torch.tensor(0.0 if img1.sum() == 0 else 100.0)
    return 20.0 * torch.log10(pixel_max / torch.sqrt(mse.clamp_min(1e-38)))


def masked_mae_pct(gt, pred, ths: float = 0.05):
    """The reference's 'MAPE': mean absolute error x100 with the prediction
    thresholded at 5% of its abs-max (CWFA.py:124-127)."""
    p = torch.where(pred.abs() < pred.abs().max() * ths,
                    torch.zeros((), dtype=pred.dtype, device=pred.device), pred)
    return (gt - p).abs().mean() * 100.0
