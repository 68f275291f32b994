"""DirectVoxGO in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of the JAX package ``directvoxgo_tpu`` that keeps its file formats
(configs, ``fixture_cache/`` ground truth, numpy-pickle checkpoints) and its
numerics. Plain tensor code is PyTorch; the hot loops of the training and
render paths are CUDA kernels in ``csrc/`` (built with ``nvcc`` at first
use):

  * ``ops/sweep_fwd.py``    — the per-ray station sweep (bilinear slab taps);
  * ``ops/sweep_bwd.py``    — its transpose onto the grid (the backward);
  * ``ops/render_frame.py`` — the fused whole-frame renderer;
  * ``ops/train_fused.py``  — the fused fine-stage train step, forward and
    backward (opt-in: ``DVGO_FUSED_TRAIN``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise.
"""

__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
