"""The port's batch draws (``engine.draws``) on the CPU: the rule that says
where windows engage, the forced-axis (MPI) window draws with their
station extent pinned to the grid's, and the fused trainer's remainder
re-bucketed through 2D windows in a whole training run.

The engine test is modelled on the JAX package's
``tests/test_fblk_remainder.py``: every fused tile goes to the remainder
(``fused_tile_classes = 0``) and windows engage at the tiny grid
(``steps_per_dispatch = 1``), so the 2D window classes carry the fine
stage.
"""

import os
import re
import types

import numpy as np
import pytest
import torch

from directvoxgo_tpu_torch.config import Config, ConfigDict
from directvoxgo_tpu_torch.data.synthetic import make_synthetic_dataset
from directvoxgo_tpu_torch.engine import checkpoint as ckpt_lib
from directvoxgo_tpu_torch.engine import draws as draws_lib
from directvoxgo_tpu_torch.engine import train as train_lib
from directvoxgo_tpu_torch.models.dmpigo import DirectMPIGO
from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO
from directvoxgo_tpu_torch.ops import sweep as sweep_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("voxels,spd,want", [
    (32 ** 3, None, False), (32 ** 3, 1, True), (128 ** 3, None, True),
    (128 ** 3, 8, False)])
def test_windows_engage_where_the_jax_engine_takes_single_steps(
        voxels, spd, want):
    """Above 1.1 M voxels or with ``steps_per_dispatch`` 1, not else."""
    cfg = ConfigDict(N_rand=512, **({} if spd is None
                                    else {"steps_per_dispatch": spd}))
    draws = types.SimpleNamespace(
        model=types.SimpleNamespace(world_size=(voxels, 1, 1)),
        cfg_train=cfg)
    assert draws_lib.Draws.windows_engage(draws) is want


def test_mpi_window_draws_pin_the_station_extent(capsys):
    """Forced-axis draws: one Morton segment of one 2D class, trained as
    (gp, eu, ev) at (0, u, v) inside the clip box; a renewal that shrinks
    the p clip leaves the key and the buckets alone."""
    model = DirectMPIGO(xyz_min=[-1, -1, 0], xyz_max=[1, 1, 1],
                        num_voxels=64 * 64 * 16, mpi_depth=16,
                        fast_color_thres=1e-4, device="cpu")
    gp, gu, gv = (int(model.world_size[a]) for a in sweep_ops._PERMS[2])
    rng = np.random.default_rng(0)
    n = 16 * 512
    j, i = np.divmod(np.arange(n), 128)        # a 64 x 128 image's pixels
    o = np.stack([i / 64.0 - 1.0, j / 32.0 - 1.0, np.zeros(n)], -1)
    d = np.stack([(i - 64) / 800.0, (j - 32) / 800.0, np.ones(n)], -1)
    perm = rng.permutation(n)
    o, d = o[perm].astype(np.float32), d[perm].astype(np.float32)
    clip_plan = {2: ((gp, gu - 8, gv - 8), np.asarray([0, 4, 4], np.int32)),
                 0: (None, np.zeros(3, np.int32)),
                 1: (None, np.zeros(3, np.int32))}
    cfg = ConfigDict(N_rand=512, steps_per_dispatch=1)
    draws = draws_lib.Draws(model, cfg, ConfigDict(stepsize=0.5), o, d, 0.0,
                            1.0, np.random.default_rng(1), clip_plan, "cpu",
                            "fine")
    draws.set_grid()
    out = capsys.readouterr().out
    assert draws.windowed and re.search(r"segment classes ax2: \(\d+, \d+\)",
                                        out), out
    built = draws.buckets[2]
    keys = set()
    for step in range(40):
        if step == 20:       # a renewal shrinks the p clip
            clip_plan[2] = ((gp - 4, gu - 8, gv - 8),
                            np.asarray([2, 4, 4], np.int32))
        sels, ax, key, offs = draws.next_chunk(1, apply_tv=True)
        sel, off = sels[0], offs[0]
        assert ax == 2 and sel.shape == (512,)
        bp, eu, ev = key
        assert bp == gp and (eu, ev) != (gu - 8, gv - 8)
        assert off[0] == 0 and 4 <= off[1] <= 4 + gu - 8 - eu
        assert 4 <= off[2] <= 4 + gv - 8 - ev
        keys.add(key)
    assert draws.buckets[2] is built        # no rebuild at the renewal
    assert all(k[0] == gp for k in keys)


def test_fused_remainder_trains_through_2d_windows(tmp_path, monkeypatch,
                                                   capsys):
    """``train()`` with ``DVGO_FUSED_TRAIN=force``, ``fused_tile_classes``
    0 and ``steps_per_dispatch`` 1: the fine stage's class histogram holds
    2-tuple (wu, wv) remainder classes, the fine stage takes composed-box
    window steps, and the checkpoint loads."""
    monkeypatch.setenv("DVGO_FUSED_TRAIN", "force")
    cfg = Config.fromfile(os.path.join(REPO, "configs", "default.py"))
    cfg.expname, cfg.basedir = "fblk_remainder", str(tmp_path)
    cfg.data.dataset_type, cfg.data.white_bkgd = "synthetic_fixture", True
    cfg.coarse_train.N_iters, cfg.coarse_train.N_rand = 60, 512
    cfg.coarse_train.lrate_density = 0.3
    cfg.fine_train.N_iters, cfg.fine_train.N_rand = 60, 512
    cfg.fine_train.pg_scale = []
    # every ray of the 10 views: a 120-step coarse stage keeps few rays
    # in its occupancy, too few for whole segments of each axis
    cfg.fine_train.ray_sampler = "flatten"
    cfg.fine_train.steps_per_dispatch = 1
    cfg.fine_train.fused_tile_classes = 0
    cfg.fine_train.remainder2d_widths = (8, 16, 24)
    cfg.coarse_model_and_render.num_voxels = 24 ** 3
    cfg.coarse_model_and_render.num_voxels_base = 24 ** 3
    cfg.fine_model_and_render.num_voxels = 32 ** 3
    cfg.fine_model_and_render.num_voxels_base = 32 ** 3
    cfg.fine_model_and_render.rgbnet_dim = 6
    cfg.fine_model_and_render.rgbnet_width = 32
    data = make_synthetic_dataset(n_train=10, n_val=1, n_test=2, H=80, W=80)
    keys = []
    orig = train_lib.make_train_step

    def recording(model, *a, **kw):
        step = orig(model, *a, **kw)

        def counted(*sa, **skw):
            keys.append((model.rgbnet is not None, kw.get("clip_sizes")))
            return step(*sa, **skw)
        return counted

    monkeypatch.setattr(train_lib, "make_train_step", recording)
    args = types.SimpleNamespace(seed=777, no_reload=False,
                                 no_reload_optimizer=False, ft_path="",
                                 i_print=100, i_weights=100000)
    train_lib.train(args, cfg, data, device="cpu")
    out = capsys.readouterr().out
    hist = [ln for ln in out.splitlines()
            if "(fine): segment classes" in ln]
    assert hist and any(re.search(r" \((\d+), (\d+)\):", ln)
                        for ln in hist), out
    fine = [k for is_fine, k in keys if is_fine]
    assert len(fine) == 60
    windowed = [k for k in fine if k is not None
                and isinstance(k[0], int) and max(k[1:]) < 32]
    assert len(windowed) >= 15, fine
    assert not any(k is not None and k[0] == "fblk" for k in fine)
    model = ckpt_lib.load_model(
        DirectVoxGO, os.path.join(cfg.basedir, cfg.expname,
                                  "fine_last.tar"), device="cpu")
    assert all(torch.isfinite(p).all() for p in model.parameters())
