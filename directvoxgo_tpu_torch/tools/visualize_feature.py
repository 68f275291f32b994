"""Panels of a checkpoint's voxel grids: mid-slices of the density grid's
activated alpha and per-channel mid-slices of the ``k0`` feature grid,
written as one PNG. The JAX package's ``tools/visualize_feature.py`` with
the same flags, plus ``--device``.

:func:`feature_panels` computes the alpha with :func:`..ops.raymarch.raw2alpha`
on the card (unless the caller asks for the CPU) and returns numpy panels;
:func:`main` reads the checkpoint (of either package) and plots them with
matplotlib, which it needs. Usage::

  python -m directvoxgo_tpu_torch.tools.visualize_feature \\
      --ckpt logs/<exp>/fine_last.tar [--out feature_vis.png] \\
      [--slice_axis 2] [--n_slices 6] [--max_channels 12] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..engine import checkpoint as ckpt_lib
from ..ops import raymarch


def feature_panels(state, model_kwargs, slice_axis=2, n_slices=6,
                   max_channels=12, device=None):
    """``(panels, titles)``: ``n_slices`` slices of the alpha grid along
    ``slice_axis``, evenly spaced, then the middle slice of each of the
    first ``max_channels`` channels of ``k0`` (where the state has a
    ``[X, Y, Z, C]`` feature grid); numpy float32 ``[.., ..]`` panels."""
    dev = resolve_device(device)
    density = np.array(state["density"], np.float32)
    with torch.no_grad():
        alpha = raymarch.raw2alpha(
            torch.as_tensor(density, device=dev),
            model_kwargs["act_shift"],
            model_kwargs.get("voxel_size_ratio", 1.0)).cpu().numpy()
    ax = slice_axis
    panels, titles = [], []
    for i in np.linspace(0, density.shape[ax] - 1, n_slices).astype(int):
        panels.append(np.take(alpha, i, axis=ax))
        titles.append(f"alpha[{ax}={i}]")
    k0 = state.get("k0")
    if k0 is not None and np.asarray(k0).ndim == 4:
        k0 = np.asarray(k0)
        mid = density.shape[ax] // 2
        for c in range(min(k0.shape[-1], max_channels)):
            panels.append(np.take(k0[..., c], mid, axis=ax))
            titles.append(f"k0[ch={c}]")
    return panels, titles


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--out", default="feature_vis.png")
    parser.add_argument("--slice_axis", type=int, default=2)
    parser.add_argument("--n_slices", type=int, default=6)
    parser.add_argument("--max_channels", type=int, default=12)
    parser.add_argument("--device", default=None,
                        help="where the alpha is computed (default: the "
                             "card; 'cpu' asks for the CPU)")
    args = parser.parse_args(argv)

    st = ckpt_lib.load_checkpoint_file(args.ckpt)
    panels, titles = feature_panels(
        st["model_state_dict"], st["model_kwargs"], args.slice_axis,
        args.n_slices, args.max_channels, args.device)

    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("visualize_feature plots with matplotlib, which "
                          "is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    n = len(panels)
    cols = min(6, n)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows))
    axes = np.atleast_1d(axes).ravel()
    for a in axes[n:]:
        a.axis("off")
    for a, p, t in zip(axes, panels, titles):
        vmax = np.abs(p).max() + 1e-9
        a.imshow(p.T, origin="lower", cmap="coolwarm",
                 vmin=-vmax if p.min() < 0 else 0, vmax=vmax)
        a.set_title(t, fontsize=8)
        a.axis("off")
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    plt.close(fig)
    print(f"wrote {args.out} ({n} panels)")


if __name__ == "__main__":
    main()
