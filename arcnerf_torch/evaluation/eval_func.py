"""Evaluation loop over a test dataset (counterpart of
``arcnerf_tpu/evaluation/eval_func.py``): per-image full render, PSNR/SSIM
and render time, images written as PNG."""

import os
import struct
import time
import zlib

import numpy as np
import torch

from ..metrics import AverageDictCounter, psnr, ssim


def run_eval(engine, dataset, logger=None, out_dir=None, max_samples=None, chunk_rays=None, compute_ssim=True,
             bkg_color=None):
    """Evaluate every (or max_samples) image of ``dataset`` through
    ``engine.render_image``. Returns (summary dict, list of per-image
    output dicts of numpy arrays)."""
    counter = AverageDictCounter()
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    results = []
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    for i in range(n):
        sample = dataset[i]
        t0 = time.perf_counter()
        imgs = engine.render_image(sample, chunk_rays, bkg_color=bkg_color)
        imgs = {k: v.cpu() for k, v in imgs.items()}  # waits for the device
        dt = time.perf_counter() - t0

        gt = torch.as_tensor(sample["img"]).reshape(imgs["rgb"].shape)
        metrics = {"psnr": float(psnr(imgs["rgb"], gt)), "fwd_time": dt}
        if compute_ssim:
            metrics["ssim"] = float(ssim(imgs["rgb"], gt))
        if "mask" in sample:
            m = torch.as_tensor(sample["mask"]).reshape(imgs["rgb"].shape[:2])
            metrics["mask_psnr"] = float(psnr(imgs["rgb"], gt, m))
        counter(metrics)
        imgs = {k: v.numpy() for k, v in imgs.items()}
        results.append(imgs)

        if out_dir:
            _write_eval_imgs(out_dir, i, imgs, gt.numpy())
        if logger is not None:
            logger.add_log("eval img {}: {}".format(i, " ".join("{}={:.3f}".format(k, v) for k, v in metrics.items())))

    summary = counter.get_avg_summary()
    if logger is not None:
        logger.add_log("Eval summary ({} imgs): {}".format(n, counter.get_metric_info()))
    if out_dir:
        with open(os.path.join(out_dir, "eval_log.txt"), "w") as f:
            f.write("n_imgs: {}\n".format(n))
            for k, v in summary.items():
                f.write("{}: {:.4f}\n".format(k, v))
    return summary, results


def _write_png(path, img):
    """img (H, W, 3) uint8 -> an 8-bit RGB PNG (zlib only)."""
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _write_eval_imgs(out_dir, idx, imgs, gt):
    """Panel of gt | prediction | depth | mask."""
    panels = [(np.clip(gt, 0, 1) * 255).astype(np.uint8), (np.clip(imgs["rgb"], 0, 1) * 255).astype(np.uint8)]
    if "depth" in imgs:
        d = imgs["depth"]
        d = (d - d.min()) / (d.max() - d.min() + 1e-8)
        panels.append((np.stack([d] * 3, -1) * 255).astype(np.uint8))
    if "mask" in imgs:
        panels.append((np.stack([np.clip(imgs["mask"], 0, 1)] * 3, -1) * 255).astype(np.uint8))
    _write_png(os.path.join(out_dir, "eval_{:03d}.png".format(idx)), np.ascontiguousarray(np.concatenate(panels, 1)))
