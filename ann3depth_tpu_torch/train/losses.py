"""Depth losses and error metrics.

Counterpart of `ann3depth_tpu/train/losses.py`. For d_i = log(pred_i) -
log(gt_i) over valid pixels, the scale-invariant loss of Eigen et al. 2014
(eq. 4) is

    L = (1/n) sum d_i^2  -  (lambda/n^2) (sum d_i)^2

Models predict log-depth, so the loss is a polynomial of the network
output. Every reduction is mask-aware (valid depth lies in
(DEPTH_EPS, MAKE3D_DEPTH_CAP]) and runs in f32 whatever the compute dtype.
Inputs are torch tensors; a mask may also be a numpy array.
"""

from __future__ import annotations

import torch

from ann3depth_tpu_torch.compat import reference_spec as ref


def _f32(x):
    return torch.as_tensor(x).to(torch.float32)


def _flatten_mask(target, mask):
    """Valid-pixel mask: provided mask AND target within (eps, cap]."""
    valid = (target > ref.DEPTH_EPS) & (target <= ref.MAKE3D_DEPTH_CAP)
    if mask is not None:
        valid = valid & torch.as_tensor(mask, device=target.device).to(
            torch.bool)
    return valid


def _aligned(pred_log, target):
    pred_log, target = _f32(pred_log), _f32(target)
    if pred_log.shape != target.shape:
        pred_log = pred_log.reshape(target.shape)
    return pred_log, target


def _axes(x):
    return tuple(range(1, x.ndim))


def eval_crop_mask(hw, crop: str, device=None):
    """[h, w] bool mask of a named literature eval crop, or None.

    crop in reference_spec.EVAL_CROPS ('eigen' | 'garg'): True inside the
    fractional window. It AND-composes with depth validity through the
    `mask` argument of every metric and alignment function here."""
    if not crop:
        return None
    try:
        top, bottom, left, right = ref.EVAL_CROPS[crop]
    except KeyError:
        raise ValueError(f"unknown eval crop {crop!r}; have "
                         f"{sorted(ref.EVAL_CROPS)}") from None
    h, w = hw
    m = torch.zeros((h, w), dtype=torch.bool, device=device)
    m[int(top * h):int(bottom * h), int(left * w):int(right * w)] = True
    return m


def _log_error(pred_log, target, mask):
    """(d zeroed at invalid pixels, valid mask) for d = pred_log - log gt."""
    pred_log, target = _aligned(pred_log, target)
    valid = _flatten_mask(target, mask)
    d = torch.where(valid, pred_log - torch.log(
        torch.clamp(target, min=ref.DEPTH_EPS)), 0.0)
    return d, valid


def per_image_si_loss(pred_log, target, mask=None, lam=ref.SI_LOSS_LAMBDA):
    """[B] per-image Eigen eq. 4 losses (sum over spatial dims per image)."""
    d, valid = _log_error(pred_log, target, mask)
    axes = _axes(d)
    n = torch.clamp(valid.sum(dim=axes).to(torch.float32), min=1.0)
    s1 = (d * d).sum(dim=axes)
    s2 = d.sum(dim=axes)
    return s1 / n - lam * (s2 * s2) / (n * n)


def scale_invariant_log_loss(pred_log, target, mask=None,
                             lam=ref.SI_LOSS_LAMBDA):
    """Scalar f32 loss: mean over the batch of the per-image losses."""
    return per_image_si_loss(pred_log, target, mask, lam).mean()


def _linear_residuals(pred_log, target, mask):
    """(|pred - gt| in meters zeroed at invalid pixels, axes, n)."""
    pred_log, target = _aligned(pred_log, target)
    valid = _flatten_mask(target, mask)
    r = torch.where(valid, torch.exp(pred_log) - target, 0.0)
    axes = _axes(r)
    n = torch.clamp(valid.sum(dim=axes).to(torch.float32), min=1.0)
    return r, axes, n


def per_image_l2_loss(pred_log, target, mask=None):
    """[B] mean squared error in linear depth (meters^2) per image."""
    r, axes, n = _linear_residuals(pred_log, target, mask)
    return (r * r).sum(dim=axes) / n


def per_image_berhu_loss(pred_log, target, mask=None):
    """[B] reverse-Huber loss in linear depth (Laina et al. 2016): L1 below
    the cutoff c = 0.2 * max|r| per image, (r^2 + c^2) / (2c) above.

    The cutoff is detached: a gradient through the max would reward a
    larger worst residual (d/dc of (a^2+c^2)/(2c) is negative for a > c)."""
    r, axes, n = _linear_residuals(pred_log, target, mask)
    a = r.abs()
    c = torch.clamp(0.2 * torch.amax(a, dim=axes, keepdim=True),
                    min=ref.DEPTH_EPS).detach()
    per_px = torch.where(a <= c, a, (a * a + c * c) / (2.0 * c))
    return per_px.sum(dim=axes) / n


def per_image_grad_loss(pred_log, target, mask=None):
    """[B] gradient-matching term on the log-depth error (Eigen & Fergus
    2015): mean over valid neighbour pairs of (nabla_x d)^2 + (nabla_y d)^2.
    A pair counts only when both of its pixels are valid."""
    d, valid = _log_error(pred_log, target, mask)
    if d.ndim >= 3 and d.shape[-1] == 1:
        # [..., H, W, 1]: drop the channel so the diffs run over H and W.
        d, valid = d[..., 0], valid[..., 0]
    vx = valid[..., :, 1:] & valid[..., :, :-1]
    dx = torch.where(vx, d[..., :, 1:] - d[..., :, :-1], 0.0)
    vy = valid[..., 1:, :] & valid[..., :-1, :]
    dy = torch.where(vy, d[..., 1:, :] - d[..., :-1, :], 0.0)
    axes = _axes(d)
    n = torch.clamp((vx.sum(dim=axes) + vy.sum(dim=axes)).to(torch.float32),
                    min=1.0)
    return ((dx * dx).sum(dim=axes) + (dy * dy).sum(dim=axes)) / n


def per_image_depth_loss(pred_log, target, mask=None, *, kind="si",
                         lam=ref.SI_LOSS_LAMBDA):
    """[B] per-image training loss of `kind`: 'si', 'si+grad' (si plus the
    gradient-matching term at unit weight), 'l2' or 'berhu'."""
    if kind == "si":
        return per_image_si_loss(pred_log, target, mask, lam)
    if kind == "si+grad":
        return (per_image_si_loss(pred_log, target, mask, lam)
                + per_image_grad_loss(pred_log, target, mask))
    if kind == "l2":
        return per_image_l2_loss(pred_log, target, mask)
    if kind == "berhu":
        return per_image_berhu_loss(pred_log, target, mask)
    raise ValueError(
        f"unknown loss kind {kind!r}; have si | si+grad | l2 | berhu")


def depth_loss(pred_log, target, mask=None, *, kind="si",
               lam=ref.SI_LOSS_LAMBDA):
    """Scalar training loss: mean over batch of per-image losses."""
    return per_image_depth_loss(pred_log, target, mask, kind=kind,
                                lam=lam).mean()


def per_image_metric_stats(pred_log, target, mask=None):
    """Per-image sufficient statistics, every leaf [B]: the sum of each leaf
    over the batch is `depth_metric_stats`, and `finalize_depth_metrics`
    maps these arrays elementwise to per-image metrics."""
    pred_log, target = _aligned(pred_log, target)
    valid = _flatten_mask(target, mask)
    axes = _axes(target)

    tgt = torch.clamp(target, min=ref.DEPTH_EPS)
    pred = torch.exp(pred_log)
    z = valid.to(torch.float32)

    diff = (pred - tgt) * z
    dlog = (pred_log - torch.log(tgt)) * z
    ratio = torch.maximum(pred / tgt,
                          tgt / torch.clamp(pred, min=ref.DEPTH_EPS))

    out = {
        "n_valid": z.sum(dim=axes),
        "sum_sq": (diff * diff).sum(dim=axes),
        "sum_sq_log": (dlog * dlog).sum(dim=axes),
        "sum_abs_rel": ((pred - tgt).abs() / tgt * z).sum(dim=axes),
        "sum_sq_rel": (diff * diff / tgt).sum(dim=axes),
        "sum_abs_log": dlog.abs().sum(dim=axes),
        # Signed log-error sum; with sum_sq_log it gives SILog.
        "sum_dlog": dlog.sum(dim=axes),
        **{f"n_delta{i}": ((ratio < 1.25 ** i) & valid).sum(dim=axes).to(
            torch.float32) for i in (1, 2, 3)},
    }
    # Per-image SILog (the KITTI leaderboard's form), summed over images.
    n1 = z.sum(dim=axes)
    n1 = n1 + (n1 < 0.5)
    sivar_img = (out["sum_sq_log"] / n1) - (out["sum_dlog"] / n1) ** 2
    out["sum_silog_img"] = (sivar_img * (sivar_img > 0)) ** 0.5
    out["n_images"] = torch.ones_like(n1)
    return out


def depth_metric_stats(pred_log, target, mask=None, si_lambda=None,
                       loss_kind="si"):
    """Dataset-level sufficient statistics: f32 scalars that sum across
    batches; `finalize_depth_metrics` of the summed dict gives the metrics
    (dataset RMSE is the root of the mean squared error over all valid
    pixels, not a mean of per-batch RMSEs).

    si_lambda, if given, also accumulates the per-image training loss of
    `loss_kind` (as sum_si_loss, whichever loss that is)."""
    stats = {k: v.sum() for k, v in per_image_metric_stats(
        pred_log, target, mask).items()}
    if si_lambda is not None:
        target = torch.as_tensor(target)
        # torch.full copies nothing from the host (a graph can capture it)
        stats["n_images"] = torch.full((), float(target.shape[0]),
                                       dtype=torch.float32,
                                       device=target.device)
        stats["sum_si_loss"] = per_image_depth_loss(
            pred_log, target, mask, kind=loss_kind, lam=si_lambda).sum()
    return stats


def finalize_depth_metrics(stats):
    """Summed stats dict -> metric dict. Works on tensors and on plain
    Python floats alike: only +, *, /, ** and comparisons are used."""
    n = stats["n_valid"]
    n = n + (n < 0.5)  # max(n, 1) without torch/numpy dispatch
    # SILog = sqrt(var of the log error), clamped at 0 by x*(x>0).
    sivar = stats["sum_sq_log"] / n - (stats["sum_dlog"] / n) ** 2
    out = {
        "rmse": (stats["sum_sq"] / n) ** 0.5,
        "rmse_log": (stats["sum_sq_log"] / n) ** 0.5,
        "abs_rel": stats["sum_abs_rel"] / n,
        "sq_rel": stats["sum_sq_rel"] / n,
        "log10": stats["sum_abs_log"] / _LOG10 / n,
        "silog": (sivar * (sivar > 0)) ** 0.5,
        **{f"delta{i}": stats[f"n_delta{i}"] / n for i in (1, 2, 3)},
    }
    if "sum_silog_img" in stats and "n_images" in stats:
        ni = stats["n_images"]
        out["silog_kitti"] = 100.0 * stats["sum_silog_img"] / (ni + (ni < 0.5))
    if "sum_si_loss" in stats:
        ni = stats["n_images"]
        out["loss"] = stats["sum_si_loss"] / (ni + (ni < 0.5))
    return out


_LOG10 = 2.302585092994046  # ln(10); a literal keeps finalize dispatch-free


def depth_metrics(pred_log, target, mask=None):
    """Error metrics over one batch: rmse (meters), rmse_log, abs_rel,
    sq_rel, log10, silog and delta1/2/3, mask-aware, f32."""
    return finalize_depth_metrics(depth_metric_stats(pred_log, target, mask))
