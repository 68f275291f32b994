"""Evaluation metrics: PSNR and SSIM (mipnerf port, numpy/scipy), and
LPIPS where the optional ``lpips`` package is installed."""

from __future__ import annotations

import numpy as np
import scipy.signal


def psnr(img, gt):
    return float(-10.0 * np.log10(np.mean(np.square(img - gt))))


def to8b(x):
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def rgb_ssim(img0, img1, max_val, filter_size=11, filter_sigma=1.5,
             k1=0.01, k2=0.03, return_map=False):
    """SSIM with an 11-tap gaussian window (the mipnerf formulation)."""
    assert len(img0.shape) == 3 and img0.shape[-1] == 3
    assert img0.shape == img1.shape
    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    filt = np.exp(-0.5 * f_i)
    filt /= np.sum(filt)

    def convolve2d(z, f):
        return scipy.signal.convolve2d(z, f, mode="valid")

    def filt_fn(z):
        return np.stack([
            convolve2d(convolve2d(z[..., i], filt[:, None]), filt[None, :])
            for i in range(z.shape[-1])], -1)

    mu0 = filt_fn(img0)
    mu1 = filt_fn(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = np.maximum(0.0, filt_fn(img0 ** 2) - mu00)
    sigma11 = np.maximum(0.0, filt_fn(img1 ** 2) - mu11)
    sigma01 = filt_fn(img0 * img1) - mu01
    sigma01 = np.sign(sigma01) * np.minimum(
        np.sqrt(sigma00 * sigma11), np.abs(sigma01))
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else float(np.mean(ssim_map))


_LPIPS_NETS = {}


def require_lpips():
    """The ``lpips`` module, or the JAX package's ``RuntimeError`` when it
    is not installed (LPIPS needs it and its pretrained weights)."""
    try:
        import lpips  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "LPIPS evaluation needs the optional 'lpips' + torch packages; "
            "install them or drop --eval_lpips_* flags") from e
    return lpips


def rgb_lpips(np_gt, np_im, net_name="alex"):
    """LPIPS (version 0.1, ``net_name`` "alex" or "vgg") of two ``[H, W, 3]``
    images in [0, 1], on the CPU."""
    import torch
    lpips = require_lpips()
    if net_name not in _LPIPS_NETS:
        _LPIPS_NETS[net_name] = lpips.LPIPS(net=net_name,
                                            version="0.1").eval()
    gt = torch.from_numpy(np.ascontiguousarray(
        np_gt.transpose(2, 0, 1))).float()
    im = torch.from_numpy(np.ascontiguousarray(
        np_im.transpose(2, 0, 1))).float()
    with torch.no_grad():
        return float(_LPIPS_NETS[net_name](gt, im, normalize=True).item())
