"""The port's data parallelism (``directvoxgo_tpu_torch.parallel``) against
the JAX package's mesh on the CPU.

Two gloo ranks, spawned once for the module (this file run as a script,
one CPU thread each, the group's store a ``FileStore`` in ``tmp_path``),
run every case through ``make_train_step(..., group=...)`` or
``make_render_fn(..., group=...)``; the same cases run in this process on
one rank (``group=None``) and through the JAX package's steps on its
8-device CPU mesh. Held at ``tests/test_parallel.py``'s bars (loss 1e-5,
PSNR 1e-3, parameters rtol 1e-2 / atol 5e-4; render chunks rtol 1e-5 /
atol 1e-6): one sweep (axis 2) and one gather train step, a render chunk,
a 4-step trajectory (as ``__graft_entry__.dryrun_multichip``: losses 1e-5
relative, parameters within 1e-2), a fused ``('fblk', ...)`` step (its
JAX counterpart on a 2-device mesh: a rank's share must be whole 512-ray
tiles), and a sparse-TV step whose two halves of the batch touch different
voxels: the all-reduce comes before TV's gate and ``skip_zero_grad``, so
a voxel only rank 1's rays reach updates on rank 0 too, and both ranks
end bit for bit equal.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
WORLD = 2
N_RAYS = 128
RK = dict(near=0.2, far=6.0, bg=1.0, stepsize=0.5)
LOSS_TOL, PSNR_TOL, RTOL, ATOL = 1e-5, 1e-3, 1e-2, 5e-4


def _cfg_train(n_rand, **kw):
    cfg = dict(N_rand=n_rand, weight_main=1.0, weight_entropy_last=0.001,
               weight_rgbper=0.01, weight_tv_density=0.0, weight_tv_k0=0.0,
               lrate_decay=20, lrate_density=1e-1, lrate_k0=1e-1,
               lrate_rgbnet=1e-3, skip_zero_grad_fields=["density", "k0"])
    cfg.update(kw)
    return cfg


# ------------------------------------------------------------ the cases

def run_case(case, group):
    """One case on the port (``group``: a DataMesh, or None for one rank):
    {"loss": [...], "psnr": [...], "params": JAX-layout tree} of its steps,
    or {"rgb", "depth"} of a render chunk."""
    from directvoxgo_tpu_torch import convert
    from directvoxgo_tpu_torch.config import ConfigDict
    from directvoxgo_tpu_torch.engine import checkpoint as ckpt
    from directvoxgo_tpu_torch.engine import render as render_lib
    from directvoxgo_tpu_torch.engine import train as train_lib
    from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO

    model = ckpt.load_model(DirectVoxGO, case["ckpt"], device="cpu")
    pool = {k: torch.tensor(v) for k, v in case["pool"].items()}
    if case["kind"] == "render":
        fn = render_lib.make_render_fn(model, RK, group=group)
        rgb, depth = fn(pool["rays_o"], pool["rays_d"], pool["viewdirs"],
                        case["axis"], case["clip_sizes"], case["clip_off"])
        return {"rgb": rgb.numpy(), "depth": depth.numpy()}
    cfg = ConfigDict(case["cfg"])
    opt = train_lib.create_optimizer_or_freeze_model(model, cfg)
    step = train_lib.make_train_step(
        model, opt, cfg, case.get("rk", RK), *case.get("tv", (False, False)),
        axis=case["axis"], clip_sizes=case["clip_sizes"], group=group)
    losses, psnrs = [], []
    for sel in case["sels"]:
        loss, psnr = step(pool, torch.tensor(sel), case["clip_off"])
        losses.append(float(loss))
        psnrs.append(float(psnr))
    return {"loss": losses, "psnr": psnrs,
            "params": convert.params_to_jax(model)[0]}


def _rank_main(rank, world, workdir):
    """A spawned rank: every case of ``workdir`` through the group."""
    torch.set_num_threads(1)
    from directvoxgo_tpu_torch.parallel import make_mesh
    mesh = make_mesh("cpu", store=torch.distributed.FileStore(
        os.path.join(workdir, "store"), world), world_size=world,
        rank=rank)
    assert (mesh.backend, mesh.world, mesh.rank) == ("gloo", world, rank)
    with open(os.path.join(workdir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    out = {name: run_case(case, mesh) for name, case in cases.items()}
    from directvoxgo_tpu_torch.parallel import replica_spread
    out["replica_spread"] = (
        replica_spread(mesh, [torch.ones(4), torch.zeros(0)]),
        replica_spread(mesh, [torch.ones(4), torch.full((3,), 0.5 * rank)]))
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from directvoxgo_tpu.config import ConfigDict as JaxConfigDict  # noqa: E402
from directvoxgo_tpu.engine import checkpoint as jax_ckpt  # noqa: E402
from directvoxgo_tpu.engine import render as jax_render  # noqa: E402
from directvoxgo_tpu.engine import train as jax_train  # noqa: E402
from directvoxgo_tpu.models.dvgo import DirectVoxGO as JaxDVGO  # noqa: E402
from directvoxgo_tpu.parallel import (make_mesh, replicate,  # noqa: E402
                                      shard_rays)
from directvoxgo_tpu_torch.ops import sweep as torch_sweep  # noqa: E402
from directvoxgo_tpu_torch.ops import train_fused as tf  # noqa: E402


def _jax_model(query_mode="sweep", num_voxels=16 ** 3, **kw):
    """``tests/test_parallel.py``'s model (and the dryrun's, larger)."""
    return JaxDVGO(**dict(dict(
        xyz_min=[-1.0, -1.0, -1.0], xyz_max=[1.0, 1.0, 1.0],
        num_voxels=num_voxels, num_voxels_base=num_voxels, alpha_init=1e-2,
        fast_color_thres=1e-4, rgbnet_dim=6, rgbnet_direct=True,
        k_density=32, k_color=16, query_mode=query_mode), **kw))


def _rays(n, seed, oz=2.5):
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.0, 0.0, oz]], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0      # dominant axis z
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, v


def _pool(o, d, v, seed):
    rgb = np.random.default_rng(seed).uniform(0, 1, o.shape).astype(
        np.float32)
    return {"rgb": rgb, "rays_o": o, "rays_d": d, "viewdirs": v}


def _save(jm, path):
    jax_ckpt.save_model_checkpoint(str(path), jm, 0)
    return str(path)


def _blob_model():
    """A 32^3 model with a density blob (its occupancy box clips the
    sweep): the fused step's and the TV case's."""
    jm = _jax_model(num_voxels=32 ** 3, k_density=None, k_color=0,
                    rgbnet_width=32, sweep_color_topk=0)
    pts = np.asarray(jm.grid_points())
    r2 = (((pts - np.array([0.05, -0.1, 0.0])) / 0.5) ** 2).sum(-1)
    jm.params["density"] = jnp.asarray(
        (14 * np.exp(-2 * r2) - 7).astype(np.float32))
    jm.params["k0"] = jnp.asarray(np.random.default_rng(11).normal(
        0, 0.5, jm.params["k0"].shape).astype(np.float32))
    jm.update_occupancy_cache()
    return jm


def _x_rays(seed, n, lo, hi):
    """Rays along +-x through the [-1, 1]^3 box, y and z in [lo, hi]."""
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = np.where(rng.uniform(size=n) < 0.5, -3.0, 3.0)
    o[:, 1:] = rng.uniform(lo, hi, (n, 2))
    d = np.zeros((n, 3), np.float32)
    d[:, 0] = -np.sign(o[:, 0])
    d[:, 1:] = rng.uniform(-0.05, 0.05, (n, 2))
    return o, d, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _fused_case(tmp):
    jm = _blob_model()
    axis, n_rand = 0, 1024
    o, d, v = _x_rays(4, 8192, -0.4, 0.4)
    from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO as TorchDVGO
    from directvoxgo_tpu_torch.engine import checkpoint as torch_ckpt
    path = _save(jm, tmp / "fused.tar")
    tm = torch_ckpt.load_model(TorchDVGO, path, device="cpu")
    csz, coff = tm.sweep_clip_for_axis(axis, quantum=8)
    bp, bu, bv = csz
    box6 = tuple(float(x) for o_, b in zip(coff, csz)
                 for x in (o_, o_ + b - 1))
    tiles = torch_sweep.build_ray_tiles_blocktile(
        o, d, tm.xyz_min, tm.xyz_max, tm.world_size, axis, 0.5, 8.0, 0.5,
        clip_box=box6)
    wins = {k: t for k, t in tiles.items()
            if k[2] and t.shape[0] >= n_rand // tf.NT
            and (k[0] < tf._round_up(bu, 16) or k[1] < tf._round_up(bv, 8))}
    key = max(wins, key=lambda k: wins[k].shape[0])
    sel = wins[key][: n_rand // tf.NT].reshape(-1)
    return jm, {"kind": "train", "ckpt": path, "pool": _pool(o, d, v, 5),
                "cfg": _cfg_train(n_rand), "axis": axis,
                "clip_sizes": ("fblk", key[0], key[1], bp, bu, bv),
                "clip_off": np.asarray(coff, np.int32), "sels": [sel],
                "rk": dict(near=0.5, far=8.0, bg=1.0, stepsize=0.5)}


def _tv_case(tmp):
    """Sparse TV over the clip box, ``skip_zero_grad`` grids: rank 0's rays
    cross the blob at y, z < 0, rank 1's at y, z > 0."""
    jm = _blob_model()
    n = 512
    lo = _x_rays(7, n // 2, -0.45, -0.1)
    hi = _x_rays(8, n // 2, 0.1, 0.45)
    o, d, v = (np.concatenate([a, b]) for a, b in zip(lo, hi))
    csz, coff = jm.sweep_clip_for_axis(0)
    return jm, {"kind": "train", "ckpt": _save(jm, tmp / "tv.tar"),
                "pool": _pool(o, d, v, 9),
                "cfg": _cfg_train(n, weight_tv_density=1e-3,
                                  weight_tv_k0=1e-4),
                "axis": 0, "clip_sizes": csz,
                "clip_off": np.asarray(coff, np.int32),
                "sels": [np.arange(n)], "tv": (True, False)}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The cases, their JAX models, and the outputs of both spawned ranks
    and of one rank in this process."""
    tmp = tmp_path_factory.mktemp("dp")
    cases, jms = {}, {}
    o, d, v = _rays(N_RAYS, 0)
    for name, mode, axis in (("sweep", "sweep", 2), ("gather", "gather",
                                                      None)):
        jm = _jax_model(mode)
        csz, coff = (jm.sweep_clip_for_axis(axis) if axis is not None
                     else (None, np.zeros(3, np.int32)))
        jms[name] = jm
        cases[name] = {"kind": "train", "ckpt": _save(jm, tmp / f"{name}.tar"),
                       "pool": _pool(o, d, v, 1), "cfg": _cfg_train(N_RAYS),
                       "axis": axis, "clip_sizes": csz,
                       "clip_off": np.asarray(coff, np.int32),
                       "sels": [np.arange(N_RAYS)]}
    jm = jms["sweep"]
    csz, coff = jm.sweep_clip_for_axis(2)
    cases["render"] = {"kind": "render", "ckpt": cases["sweep"]["ckpt"],
                       "pool": _pool(*_rays(N_RAYS, 3), 0), "axis": 2,
                       "clip_sizes": csz,
                       "clip_off": np.asarray(coff, np.int32)}
    jm = jms["trajectory"] = _jax_model(num_voxels=32 ** 3)
    n_traj = 4096
    rng = np.random.default_rng(7)
    csz, coff = jm.sweep_clip_for_axis(2)
    cases["trajectory"] = {
        "kind": "train", "ckpt": _save(jm, tmp / "traj.tar"),
        "pool": _pool(*_rays(n_traj, 0, oz=3.5), 0),
        "cfg": _cfg_train(n_traj), "axis": 2, "clip_sizes": csz,
        "clip_off": np.asarray(coff, np.int32),
        "sels": [rng.permutation(n_traj) for _ in range(4)],
        "rk": dict(near=0.5, far=8.0, bg=1.0, stepsize=0.5)}
    jms["fused"], cases["fused"] = _fused_case(tmp)
    jms["tv"], cases["tv"] = _tv_case(tmp)
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, HERE, str(r), str(WORLD),
                               str(tmp)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {name: run_case(case, None) for name, case in cases.items()}
    finally:
        torch.set_num_threads(n)
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return cases, jms, ranks, one


def _jax_steps(jm, case, n_devices=None):
    """The case's steps through the JAX package's step on its CPU mesh."""
    cfg = JaxConfigDict(case["cfg"])
    opt = jax_train.create_optimizer_or_freeze_model(jm, cfg)
    state = opt.init(jm.params)
    mesh = make_mesh(None if n_devices is None
                     else jax.devices()[:n_devices])
    step = jax_train.make_train_step(
        jm, opt, cfg, case.get("rk", RK), *case.get("tv", (False, False)),
        axis=case["axis"], clip_sizes=case["clip_sizes"], mesh=mesh)
    pool = jax.device_put({k: jnp.asarray(v) for k, v in
                           case["pool"].items()}, replicate(mesh))
    params, losses, psnrs = jm.params, [], []
    for sel in case["sels"]:
        sel = jax.device_put(jnp.asarray(sel, jnp.int32),
                             shard_rays(mesh, ndim=1))
        params, state, loss, psnr = step(params, jm.mask, state, pool, sel,
                                         jnp.asarray(case["clip_off"]))
        losses.append(float(loss))
        psnrs.append(float(psnr))
    return {"loss": losses, "psnr": psnrs,
            "params": jax.tree_util.tree_map(np.asarray, params)}


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _hold(got, ref, what):
    """``tests/test_parallel.py``'s bars."""
    for a, b in zip(got["loss"], ref["loss"]):
        assert abs(a - b) < LOSS_TOL, (what, got["loss"], ref["loss"])
    for a, b in zip(got["psnr"], ref["psnr"]):
        assert abs(a - b) < PSNR_TOL, (what, got["psnr"], ref["psnr"])
    la, lb = _leaves(got["params"]), _leaves(ref["params"])
    assert len(la) == len(lb)
    for i, (a, b) in enumerate(zip(la, lb)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: leaf {i}")


def _ranks_agree(ranks, name):
    """Replicated state: both ranks end bit for bit equal."""
    a, b = ranks[0][name], ranks[1][name]
    assert a["loss"] == b["loss"] and a["psnr"] == b["psnr"]
    for x, y in zip(_leaves(a["params"]), _leaves(b["params"])):
        assert np.array_equal(x, y), name


@pytest.mark.parametrize("name", ["sweep", "gather"])
def test_train_step_two_ranks_match_one_and_jax_mesh(dp, name):
    """One train step (sweep axis 2, or the gather step) of two gloo ranks
    against one rank and against the JAX package's 8-device mesh."""
    cases, jms, ranks, one = dp
    _ranks_agree(ranks, name)
    assert np.isfinite(ranks[0][name]["loss"]).all()
    _hold(ranks[0][name], one[name], f"{name}: two ranks vs one")
    _hold(ranks[0][name], _jax_steps(jms[name], cases[name]),
          f"{name}: two ranks vs the JAX mesh")


def test_render_chunk_two_ranks_match_one_and_jax_mesh(dp):
    cases, jms, ranks, one = dp
    case, jm = cases["render"], jms["sweep"]
    mesh = make_mesh()
    fn = jax_render.make_render_fn(jm, RK, mesh=mesh)
    rays = {k: jax.device_put(jnp.asarray(case["pool"][k]),
                              shard_rays(mesh))
            for k in ("rays_o", "rays_d", "viewdirs")}
    rgb_j, dep_j = fn(jax.device_put(jm.params, replicate(mesh)),
                      jax.device_put(jm.mask, replicate(mesh)),
                      rays["rays_o"], rays["rays_d"], rays["viewdirs"], 2,
                      case["clip_sizes"], jnp.asarray(case["clip_off"]))
    for r in range(WORLD):
        got = ranks[r]["render"]
        for key, ref in (("rgb", rgb_j), ("depth", dep_j)):
            np.testing.assert_allclose(got[key], one["render"][key],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got[key], np.asarray(ref),
                                       rtol=1e-5, atol=1e-6)


def test_four_step_trajectory_matches_jax_mesh(dp):
    """``dryrun_multichip``'s check (at 32^3 and 4096 rays, its 48^3 and
    8192 cut for time), on the plain versions: against one rank and the
    8-device mesh, each step's loss within 1e-5 relative, parameters
    within 1e-2 after four steps."""
    cases, jms, ranks, one = dp
    _ranks_agree(ranks, "trajectory")
    got = ranks[0]["trajectory"]
    for ref in (one["trajectory"],
                _jax_steps(jms["trajectory"], cases["trajectory"])):
        for a, b in zip(got["loss"], ref["loss"]):
            assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (got["loss"],
                                                           ref["loss"])
        dmax = max(float(np.abs(a - b).max()) for a, b in zip(
            _leaves(got["params"]), _leaves(ref["params"])))
        assert dmax < 1e-2, dmax


def test_fused_step_two_ranks_match_one_and_jax_mesh(dp, monkeypatch):
    """A fused step: each rank takes one 512-ray tile of the 1024-ray
    batch (kernels K-D and K-E, plain versions); the JAX package's
    ``shard_map`` step on a 2-device mesh is its counterpart."""
    cases, jms, ranks, one = dp
    _ranks_agree(ranks, "fused")
    _hold(ranks[0]["fused"], one["fused"], "fused: two ranks vs one")
    _hold(ranks[0]["fused"], _jax_steps(jms["fused"], cases["fused"],
                                        n_devices=WORLD),
          "fused: two ranks vs the JAX mesh")


def test_sparse_tv_acts_on_the_all_reduced_gradient(dp):
    """The voxels only rank 1's rays reach (zero gradient from rank 0's
    half of the batch) update on rank 0 as on rank 1, TV's gate and
    ``skip_zero_grad`` reading the full batch's gradient; the step matches
    one rank and the JAX mesh."""
    from directvoxgo_tpu_torch.engine import checkpoint as torch_ckpt
    from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO as TorchDVGO
    cases, jms, ranks, one = dp
    case = cases["tv"]
    _ranks_agree(ranks, "tv")
    _hold(ranks[0]["tv"], one["tv"], "tv: two ranks vs one")
    _hold(ranks[0]["tv"], _jax_steps(jms["tv"], case), "tv: vs JAX mesh")

    tm = torch_ckpt.load_model(TorchDVGO, case["ckpt"], device="cpu")
    pool = {k: torch.tensor(x) for k, x in case["pool"].items()}
    touched = []
    for half in (slice(0, 256), slice(256, 512)):
        ret = tm.forward_sweep(pool["rays_o"][half], pool["rays_d"][half],
                               pool["viewdirs"][half], 0, **RK)
        g, = torch.autograd.grad(ret["rgb_marched"].sum(), [tm.density])
        touched.append(g != 0)
    only_rank1 = (touched[1] & ~touched[0]).numpy()
    assert only_rank1.sum() > 100
    d0 = np.asarray(jms["tv"].params["density"])
    moved = ranks[0]["tv"]["params"]["density"] != d0
    assert moved[only_rank1].mean() > 0.99


@pytest.mark.parametrize("name", ["sweep", "trajectory", "tv"])
def test_one_rank_group_steps_bit_for_bit_as_no_group(dp, tmp_path, name):
    """A group of one rank: its all-reduce returns what it is given, and
    the f32 cotangents it reduces are rounded to bf16 after it, where the
    plain step rounds them (the sweep's grid cotangent, the colour MLP's
    weights), so its steps equal the plain steps bit for bit."""
    from directvoxgo_tpu_torch.parallel import make_mesh as torch_mesh
    cases, _, _, one = dp
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh = torch_mesh("cpu", store=torch.distributed.FileStore(
        str(tmp_path / "store"), 1), world_size=1, rank=0)
    try:
        got = run_case(cases[name], mesh)
    finally:
        torch.distributed.destroy_process_group()
        torch.set_num_threads(n)
    assert got["loss"] == one[name]["loss"]
    assert got["psnr"] == one[name]["psnr"]
    for a, b in zip(_leaves(got["params"]), _leaves(one[name]["params"])):
        assert np.array_equal(a, b), name


def test_replica_spread_finds_a_rank_that_differs(dp):
    """The loop's end-of-stage report: 0.0 where the ranks hold the same
    tensors, else the largest difference from rank 0's, on every rank."""
    _, _, ranks, _ = dp
    assert [r["replica_spread"] for r in ranks] == [(0.0, 0.5)] * WORLD
