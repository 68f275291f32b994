"""The FLOP and byte counts on hand-worked shapes."""

import numpy as np
import torch

from portbench import counts
from portbench.reference import sweep_field as ref


def test_mlp_and_step_flops():
    assert counts.mlp_macs([39, 128, 128, 3]) == 21760
    c = {"n_color": 10, "n_inbox": 100}
    # MLP 10 x 2 x (2*3 + 3*1) forward, 100 x 3 channels x 16 interpolation
    assert counts.step_flops(c, [2, 3, 1], 3, train=False) == 180 + 4800
    assert counts.step_flops(c, [2, 3, 1], 3, train=True) == 540 + 9600


def test_kernel_bytes():
    c = {"vox_read": 5, "n_rays": 2, "n_inbox": 7, "vox_density": 4,
         "vox_k0": 3}
    # 5 voxels x (3 floats + the mask byte) + 2 rays x 24 + 7 x 4 values
    assert counts.ka_bytes(c, 2) == 5 * 13 + 48 + 7 * 16
    assert counts.kc_bytes(c, 2) == 7 * 12 + 48 + 5 * 12
    assert counts.kf_bytes(c, 1000, 2, dense=True) == 3 * 4 * 1000 * 3
    assert counts.kf_bytes(c, 1000, 2, dense=False) == 3 * 4 * (4 + 3 * 2)
    peaks = {"f32_flops": 1e3, "hbm_bytes_per_s": 10.0}
    assert counts.bound_seconds(2e3, 10.0, peaks) == 2.0
    assert counts.bound_seconds(1e3, 30.0, peaks) == 3.0


def tiny_field():
    """A 4x4x4 grid on [0, 3]^3 (voxel = world coordinates), stepsize 0.5,
    no colour compaction."""
    cfg = {"fine_model_and_render": {"stepsize": 0.5,
                                     "fast_color_thres": 1e-4,
                                     "sweep_color_topk": 0,
                                     "viewbase_pe": 0, "rgbnet_direct": True},
           "fine_train": {"N_rand": 1}}
    geo = {"kind": "dvgo", "world_size": (4, 4, 4), "xyz_min": [0.0] * 3,
           "xyz_max": [3.0] * 3, "act_shift": 0.0, "voxel_size_base": 1.0,
           "voxel_size_ratio": 1.0}
    return ref.Field(cfg, geo, 0.0, 10.0, 1.0)


def test_reference_counts_one_ray():
    field = tiny_field()
    params = {"density": torch.full((4, 4, 4), 2.0),
              "k0": torch.zeros(4, 4, 4, 2),
              "mask": torch.ones(4, 4, 4, dtype=torch.bool),
              "mlp": [(torch.zeros(3, 5), torch.zeros(3))]}
    ro = torch.tensor([[-1.0, 1.5, 1.5]])
    rd = torch.tensor([[1.0, 0.0, 0.0]])
    _, _, c = field.render(params, ro, rd, rd, torch.float32,
                           want_counts=True)
    c = ref.count_values(c)
    # stations at x = 0, 0.5, ..., 3: seven, all inside the box; they read
    # x in 0..3 and y, z in {1, 2}: 16 voxels
    assert c["n_rays"] == 1 and c["n_inbox"] == 7
    assert c["vox_read"] == 16
    # alpha 1 - exp(-softplus(2) * 0.5) ~ 0.65: the transmittance passes
    # 1e-3 for the first seven samples, every one a colour sample
    assert c["n_color"] == 7
    assert np.isclose(c["vox_density"], 16)
