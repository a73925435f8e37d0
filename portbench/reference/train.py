"""Reference of the preprocess, the loss and the update.

- Preprocess (no augmentation): uint8 RGB resized to the input size with
  an antialiased bilinear triangle (half-pixel centres), scaled to [0, 1]
  and standardised per channel; depth resized to the target size with a
  validity mask (valid is (1e-6, 70] m): the resized depth over the resized
  mask where that mask is at least 0.5, else 0.
- Loss "si" (Eigen et al. 2014, eq. 4) on d = pred_log - log(gt) over the
  valid pixels of each image: mean(d^2) - lambda * mean(d)^2, averaged over
  the batch.
- Update: gradients clipped to a global norm (scaled by clip / norm when
  the norm exceeds clip), then AdamW with bias correction, eps 1e-8, the
  learning rate warmed up linearly from 0 over `warmup_steps` and decayed
  to 0 by a cosine at `steps`.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import ops

RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)
DEPTH_EPS = 1e-6
DEPTH_CAP = 70.0


def _resize_nhwc(x, out_hw):
    ay = ops.resize_matrix(out_hw[0], x.shape[1], x.device)
    ax = ops.resize_matrix(out_hw[1], x.shape[2], x.device)
    y = torch.einsum("oh,bhwc->bowc", ay, x)
    return torch.einsum("pw,bowc->bopc", ax, y)


def preprocess_image(img_u8, input_hw):
    """uint8 NHWC -> standardised f32 NHWC at input_hw."""
    z = _resize_nhwc(img_u8.to(torch.float32), input_hw) / 255.0
    mean = torch.tensor(RGB_MEAN, device=z.device)
    std = torch.tensor(RGB_STD, device=z.device)
    return (z - mean) / std


def preprocess_depth(depth, target_hw):
    """f32 [B, h, w] metres -> [B, th, tw], 0 where too little was valid."""
    x = depth.to(torch.float32)[..., None]
    valid = ((x > DEPTH_EPS) & (x <= DEPTH_CAP)).to(torch.float32)
    z = _resize_nhwc(x * valid, target_hw)
    zv = _resize_nhwc(valid, target_hw)
    d = z / zv.clamp(min=1e-6)
    return torch.where(zv >= 0.5, d, torch.zeros_like(d))[..., 0]


def si_loss(pred_log, target, lam):
    pred_log = pred_log.reshape(target.shape)
    valid = (target > DEPTH_EPS) & (target <= DEPTH_CAP)
    d = torch.where(valid, pred_log - torch.log(target.clamp(min=DEPTH_EPS)),
                    torch.zeros_like(pred_log))
    axes = tuple(range(1, d.ndim))
    n = valid.sum(dim=axes).to(torch.float32).clamp(min=1.0)
    s1 = (d * d).sum(dim=axes)
    s2 = d.sum(dim=axes)
    return (s1 / n - lam * s2 * s2 / (n * n)).mean()


def learning_rate(count, lr, warmup_steps, total_steps):
    if count < warmup_steps:
        return lr * count / warmup_steps
    decay = max(total_steps, warmup_steps + 1) - warmup_steps
    c = min(count - warmup_steps, decay)
    return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))


def train_readings(model, model_cfg, train_cfg, params0, batches, *,
                   input_hw, target_hw, lowp=None):
    """Run len(batches) training steps from params0 (untouched).

    Returns {"loss": [per step], "grad_norm": {leaf: norm of its first
    (clipped) gradient}, "change": {leaf: norm of its change after the
    last step}}, as Python floats, and "grad": {leaf: its first (clipped)
    gradient}, as f32 tensors on the device it ran on."""
    names = list(params0)
    p = {k: params0[k].detach().clone().requires_grad_(True) for k in names}
    m = {k: torch.zeros_like(params0[k]) for k in names}
    v = {k: torch.zeros_like(params0[k]) for k in names}
    b1, b2 = train_cfg["adam_b1"], train_cfg["adam_b2"]
    out = {"loss": []}
    for t, (img_u8, depth) in enumerate(batches, start=1):
        x = preprocess_image(img_u8, input_hw)
        d = preprocess_depth(depth, target_hw)
        loss = si_loss(model.forward(p, x, model_cfg, lowp=lowp), d,
                       train_cfg["si_lambda"])
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            clip = train_cfg["clip_norm"]
            factor = 1.0 if clip <= 0 or float(norm) < clip else clip / norm
            grads = [g * factor for g in grads]
            if t == 1:
                out["grad"] = dict(zip(names, grads))
                out["grad_norm"] = {k: float(g.double().norm())
                                    for k, g in zip(names, grads)}
            lr = learning_rate(t - 1, train_cfg["learning_rate"],
                               train_cfg["warmup_steps"], train_cfg["steps"])
            wd = train_cfg["weight_decay"]
            for k, g in zip(names, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[k] / (1 - b1 ** t)
                v_hat = v[k] / (1 - b2 ** t)
                p[k].mul_(1 - lr * wd)
                p[k].sub_(lr * m_hat / (v_hat.sqrt() + 1e-8))
    with torch.no_grad():
        out["change"] = {k: float((p[k] - params0[k]).double().norm())
                         for k in names}
    return out
