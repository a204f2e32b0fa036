"""Image metrics and averaging counter (counterpart of
``arcnerf_tpu/metrics/__init__.py``: psnr, ssim, AverageDictCounter)."""

import torch
import torch.nn.functional as F


def psnr(pred, gt, mask=None):
    """pred/gt (..., 3) in [0, 1]; mask optional broadcastable to (...)."""
    err = (pred - gt) ** 2
    if mask is not None:
        while mask.ndim < err.ndim:
            mask = mask[..., None]
        mse = (err * mask).sum() / torch.clamp_min(mask.sum() * (err.numel() / mask.numel()), 1.0)
    else:
        mse = err.mean()
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-10))


def _gaussian_kernel(size=11, sigma=1.5):
    x = torch.arange(size, dtype=torch.float32) - size // 2
    g = torch.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def ssim(pred, gt, mask=None):
    """SSIM over (H, W, 3) images with an 11x11 gaussian window (separable,
    edge-padded)."""
    c1, c2 = 0.01**2, 0.03**2
    kern = _gaussian_kernel().to(pred.device)
    half = kern.shape[0] // 2

    def blur(img):
        x = img.permute(2, 0, 1)[:, None]  # (C, 1, H, W)
        x = F.conv2d(F.pad(x, (0, 0, half, half), mode="replicate"), kern.view(1, 1, -1, 1))
        x = F.conv2d(F.pad(x, (half, half, 0, 0), mode="replicate"), kern.view(1, 1, 1, -1))
        return x[:, 0].permute(1, 2, 0)

    mu_p, mu_g = blur(pred), blur(gt)
    sigma_p = blur(pred**2) - mu_p**2
    sigma_g = blur(gt**2) - mu_g**2
    sigma_pg = blur(pred * gt) - mu_p * mu_g
    ssim_map = ((2 * mu_p * mu_g + c1) * (2 * sigma_pg + c2)) / ((mu_p**2 + mu_g**2 + c1) * (sigma_p + sigma_g + c2))
    if mask is not None:
        while mask.ndim < ssim_map.ndim:
            mask = mask[..., None]
        return (ssim_map * mask).sum() / torch.clamp_min(mask.sum() * (ssim_map.numel() / mask.numel()), 1.0)
    return ssim_map.mean()


class AverageDictCounter:
    """Running average of metric dicts."""

    def __init__(self):
        self.totals = {}
        self.count = 0

    def __call__(self, values, batch_size=1):
        for k, v in values.items():
            if k == "names":
                continue
            self.totals[k] = self.totals.get(k, 0.0) + float(v) * batch_size
        self.count += batch_size

    def get_avg_summary(self):
        if self.count == 0:
            return {}
        return {k: v / self.count for k, v in self.totals.items()}

    def get_metric_info(self):
        return " | ".join("{}: {:.4f}".format(k, v) for k, v in self.get_avg_summary().items())
