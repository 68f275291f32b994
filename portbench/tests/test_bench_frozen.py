"""The benchmark's frozen copies of the fixture's camera, teacher and ray
arithmetic equal the port's, and its geometry the port's grid."""

import os
import types

import numpy as np
import pytest

from directvoxgo_tpu_torch import rays as port_rays
from directvoxgo_tpu_torch.data import synthetic
from directvoxgo_tpu_torch.engine import train as port_train
from directvoxgo_tpu_torch.config import Config
from directvoxgo_tpu_torch.models.dmpigo import DirectMPIGO
from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO
from portbench import inputs
from portbench.run import HERE, read_json


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_cameras(seed):
    d = synthetic.make_synthetic_dataset(n_train=8, n_val=1, n_test=2, H=32,
                                         W=32, seed=seed, device="cpu")
    poses, K = inputs.synthetic_cameras(8, 1, 2, 32, 32, seed)
    np.testing.assert_array_equal(poses, d["poses"])
    np.testing.assert_array_equal(K, d["Ks"][0])


@pytest.mark.parametrize("seed", [0, 3])
def test_ndc_cameras(seed, tmp_path):
    if seed:
        # an uncached fixture key renders its teacher: keep it small
        kw = dict(n_train=2, n_val=1, n_test=1, H=8, W=8, teacher_res=8,
                  cache_dir=str(tmp_path))
    else:
        kw = dict(n_train=12, n_val=2, n_test=3, H=64, W=64, teacher_res=64)
    d = synthetic.make_ndc_fixture_dataset(seed=seed, device="cpu", **kw)
    poses, K = inputs.ndc_cameras(kw["n_train"], kw["n_val"], kw["n_test"],
                                  kw["H"], kw["W"], seed)
    np.testing.assert_array_equal(poses, d["poses"])
    np.testing.assert_array_equal(K, d["Ks"][0])


@pytest.mark.parametrize("variant", ["blobs", "lego"])
def test_teacher(variant):
    a = synthetic.teacher_grids(16, variant)
    b = inputs.teacher_grids(16, variant)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("ndc", [False, True])
def test_pixel_rays(ndc):
    poses, K = inputs.ndc_cameras(2, 0, 0, 12, 16, 0)
    for ours, port in zip(inputs.pixel_rays_np(12, 16, K, poses[1], ndc),
                          port_rays.get_rays_of_a_view(
                              np.int64(12), np.int64(16), K, poses[1], ndc,
                              False, False, False)):
        np.testing.assert_array_equal(ours, port)


def test_ndc_border_bbox_and_fixture_images():
    cfg = read_json(os.path.join(HERE, "configs", "fern_mpi.json"))
    cfg["fixture"] = {"kind": "ndc", "file":
                      "fixture_ndc_12_2_3_64_64_64_0_v1.npz", "n_train": 12,
                      "n_val": 2, "n_test": 3, "H": 64, "W": 64,
                      "teacher_res": 64, "seed": 0}
    data = inputs.fixture(cfg)
    d = synthetic.make_ndc_fixture_dataset(n_train=12, n_val=2, n_test=3,
                                           H=64, W=64, teacher_res=64,
                                           device="cpu")
    np.testing.assert_array_equal(data["images"], d["images"])
    pcfg = Config({"data": {"ndc": True, "inverse_y": False,
                            "flip_x": False, "flip_y": False}})
    lo, hi = port_train.compute_bbox_by_cam_frustrm(pcfg, **d)
    ours = inputs.frustum_bbox(data)
    np.testing.assert_array_equal(ours[0], lo)
    np.testing.assert_array_equal(ours[1], hi)


@pytest.mark.parametrize("name", ["lego_fine", "fern_mpi"])
def test_geometry_is_the_ports_grid(name):
    """The configuration's grid, worked out by the benchmark, is the one
    the port's model sets (its resolution code on a stand-in object)."""
    cfg = read_json(os.path.join(HERE, "configs", f"{name}.json"))
    m = cfg["fine_model_and_render"]
    if name == "fern_mpi":
        # the NDC box of fern's fixture layout (no images needed)
        poses, K = inputs.ndc_cameras(17, 1, 3, 756, 1008, 0)
        data = {"poses": poses, "K": K, "H": 756, "W": 1008, "near": 0.0,
                "far": 1.0, "i_train": np.arange(17), "ndc": True}
        geo = inputs.geometry(cfg, data)
        obj = types.SimpleNamespace(xyz_min=geo["xyz_min"],
                                    xyz_max=geo["xyz_max"])
        DirectMPIGO._set_grid_resolution(obj, m["num_voxels"],
                                         m["mpi_depth"])
        assert obj.world_size == (352, 371, 128)
    else:
        poses, K = inputs.synthetic_cameras(40, 2, 4, 400, 400, 0)
        data = {"poses": poses, "K": K, "H": 400, "W": 400, "near": 2.0,
                "far": 6.0, "i_train": np.arange(40), "ndc": False}
        geo = inputs.geometry(cfg, data)
        obj = types.SimpleNamespace(xyz_min=geo["xyz_min"],
                                    xyz_max=geo["xyz_max"],
                                    world_size_quantum=m["world_size_quantum"],
                                    voxel_size_base=geo["voxel_size_base"])
        DirectVoxGO._set_grid_resolution(obj, m["num_voxels"])
        assert np.isclose(obj.voxel_size_ratio, geo["voxel_size_ratio"])
    assert tuple(obj.world_size) == tuple(geo["world_size"])
    assert np.isclose(obj.voxel_size, geo["voxel_size"])


def test_synthetic_bbox_and_coarse_mask():
    """The coarse stage's box is the port's frustum box, and the mask
    cache the port's rule (``alpha(maxpool3) >= thres``, nearest coarse
    voxel, False outside the coarse box)."""
    import torch
    from directvoxgo_tpu_torch.ops import grid as grid_ops
    from directvoxgo_tpu_torch.ops import raymarch as rm
    cfg = read_json(os.path.join(HERE, "configs", "lego_fine.json"))
    cfg["coarse_model_and_render"]["num_voxels"] = 32 ** 3
    cfg["fine_model_and_render"]["num_voxels"] = 24 ** 3
    cfg["fine_model_and_render"]["num_voxels_base"] = 24 ** 3
    cfg["fixture"].update(teacher_res=32)
    poses, K = inputs.synthetic_cameras(8, 1, 2, 32, 32, 0)
    data = {"poses": poses, "K": K, "H": 32, "W": 32, "near": 2.0,
            "far": 6.0, "i_train": np.arange(8), "ndc": False}
    d = synthetic.make_synthetic_dataset(n_train=8, n_val=1, n_test=2, H=32,
                                         W=32, seed=0, device="cpu")
    pcfg = Config({"data": {"ndc": False, "inverse_y": False,
                            "flip_x": False, "flip_y": False}})
    lo, hi = port_train.compute_bbox_by_cam_frustrm(
        pcfg, **{**d, "near": 2.0, "far": 6.0})
    ours = inputs.frustum_bbox(data)
    np.testing.assert_array_equal(ours[0], lo)
    np.testing.assert_array_equal(ours[1], hi)
    geo = inputs.geometry(cfg, data)
    c = geo["coarse"]
    occ = rm.raw2alpha(grid_ops.max_pool3d_same(c["density"]),
                       geo["act_shift"], 1.0) >= geo["mask_cache_thres"]
    pts = inputs.grid_points({"xyz_min": c["xyz_min"] - 0.3,
                              "xyz_max": c["xyz_max"] + 0.3,
                              "world_size": (40, 41, 42)},
                             torch.device("cpu"))
    want = grid_ops.occupancy_lookup_parts(
        occ, pts[..., 0], pts[..., 1], pts[..., 2],
        [float(v) for v in c["xyz_min"]], [float(v) for v in c["xyz_max"]])
    got = inputs.coarse_mask_on(geo, pts)
    assert got.any() and not got.all()
    assert torch.equal(got, want)
