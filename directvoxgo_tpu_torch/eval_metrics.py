"""Offline metrics of saved renders: PSNR, and SSIM and LPIPS on request,
of a directory of rendered PNG frames against the dataset's ground truth
of one split. The JAX package's ``eval_metrics.py`` with the same flags,
printed lines and ``_metrics.txt``.

The work is host numpy (the PNGs through :func:`.data.image_io.read_png`,
the metrics through :mod:`.engine.metrics`), as in the JAX script. Only a
procedural fixture whose ground truth is not cached renders it, on the
card. The frames are the directory's ``*.png`` files in name order, less
the ``depth_*.png`` that the port's driver writes beside them. Usage::

  python -m directvoxgo_tpu_torch.eval_metrics \\
      --render_dir logs/.../render_test_fine_last \\
      --config configs/nerf/lego.py [--split test] [--eval_ssim] \\
      [--eval_lpips_alex] [--eval_lpips_vgg]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from .config import Config
from .data import load_everything
from .data.image_io import read_png
from .engine import metrics as metrics_lib


def main(argv=None):
    """Scores the frames; prints and writes the report, and returns it as
    ``{"psnr": ..., "ssim": ..., ...}`` (the metrics asked for)."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--render_dir', required=True,
                        help='directory of rendered ???.png frames')
    parser.add_argument('--config', required=True)
    parser.add_argument('--split', default='test',
                        choices=['train', 'val', 'test'])
    parser.add_argument('--eval_ssim', action='store_true')
    parser.add_argument('--eval_lpips_alex', action='store_true')
    parser.add_argument('--eval_lpips_vgg', action='store_true')
    args = parser.parse_args(argv)
    if args.eval_lpips_alex or args.eval_lpips_vgg:
        metrics_lib.require_lpips()

    cfg = Config.fromfile(args.config)
    data_dict = load_everything(args=args, cfg=cfg)
    idx = data_dict[f'i_{args.split}']
    gts = [np.asarray(data_dict['images'][i], np.float32) for i in idx]

    files = [f for f in sorted(glob.glob(os.path.join(args.render_dir,
                                                       '*.png')))
             if not os.path.basename(f).startswith('depth_')]
    if len(files) != len(gts):
        raise ValueError(f'{len(files)} renders vs {len(gts)} GT views')

    scores = {'psnr': [], 'ssim': [], 'lpips_alex': [], 'lpips_vgg': []}
    for f, gt in zip(files, gts):
        img = (read_png(f) / 255.0).astype(np.float32)[..., :3]
        scores['psnr'].append(metrics_lib.psnr(img, gt))
        if args.eval_ssim:
            scores['ssim'].append(metrics_lib.rgb_ssim(img, gt, max_val=1))
        if args.eval_lpips_alex:
            scores['lpips_alex'].append(metrics_lib.rgb_lpips(gt, img,
                                                              'alex'))
        if args.eval_lpips_vgg:
            scores['lpips_vgg'].append(metrics_lib.rgb_lpips(gt, img, 'vgg'))

    means = {k: float(np.mean(v)) for k, v in scores.items() if v}
    report = '\n'.join(f'{k} {v:.4f}' for k, v in means.items())
    print(report)
    out_path = os.path.join(args.render_dir, '_metrics.txt')
    with open(out_path, 'w') as fh:
        fh.write(report + '\n')
    print('wrote', out_path)
    return means


if __name__ == '__main__':
    main()
