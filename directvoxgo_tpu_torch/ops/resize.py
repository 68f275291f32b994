"""Area resize of images (OpenCV's ``INTER_AREA`` downscale) in PyTorch.

Each output pixel is the mean of the source area it covers: at a whole
factor a box mean, at a fractional one (``400 // 3 = 133``) the source
pixels on the cell's border weigh by the share of them that lies inside.
The weights are OpenCV's (``computeResizeAreaTab``) and separable, so the
resize is two small matrix products, rows after columns as OpenCV sums
them, on the image's device. The conditioning images of the conditioned
drivers are resized here on every step, so no step goes through ``cv2``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def area_weights(n_in, n_out):
    """``[n_out, n_in]`` float64 weights of OpenCV's area resize along one
    axis (``n_out <= n_in``); each row sums to 1."""
    if n_out > n_in:
        raise ValueError(f"area resize downscales only ({n_in} -> {n_out})")
    scale = 1.0 / (n_out / n_in)
    w = np.zeros((n_out, n_in), np.float64)
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] += (s1 - f1) / cell
        w[d, s1:s2] += 1.0 / cell
        if f2 - s2 > 1e-3:
            w[d, s2] += min(min(f2 - s2, 1.0), cell) / cell
    return w


_WEIGHTS = {}


def _weights_on(n_in, n_out, device):
    key = (n_in, n_out, str(device))
    if key not in _WEIGHTS:
        _WEIGHTS[key] = torch.as_tensor(
            area_weights(n_in, n_out).astype(np.float32), device=device)
    return _WEIGHTS[key]


def area_resize(img, out_h, out_w):
    """``img [..., H, W, C]`` (f32 tensor) -> ``[..., out_h, out_w, C]``,
    as ``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_AREA)``
    does for each image."""
    h, w = img.shape[-3], img.shape[-2]
    if (h, w) == (out_h, out_w):
        return img
    aw = _weights_on(w, out_w, img.device)
    ah = _weights_on(h, out_h, img.device)
    cols = torch.einsum("...hwc,pw->...hpc", img, aw)
    return torch.einsum("oh,...hpc->...opc", ah, cols)
