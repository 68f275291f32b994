"""The port's window-bucket functions against the JAX package's on the CPU.

``build_tile_buckets``, ``build_ray_segments`` (v-windows),
``build_ray_segments_2d``, ``build_ray_segments_blocked`` and
``blocked_p_rows`` must return exactly what the JAX package's do on the
same numpy rays: the same keys, the same ray indices, the same window
offsets. So must the fused trainer's remainder re-bucketing
(``engine.draws.rebucket_remainder``), held against the JAX engine's steps
(``engine/train.py`` ``build_buckets``) spelled out here with the JAX
functions, including a remainder padded up to one segment.
"""

import numpy as np
import pytest

from directvoxgo_tpu.ops import sweep as jax_sweep
from directvoxgo_tpu_torch.engine import draws as torch_draws
from directvoxgo_tpu_torch.ops import sweep as torch_sweep

XYZ_MIN, XYZ_MAX = [-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]
WORLD = (48, 40, 56)


def _fan_rays(seed, n, axis, spread=0.1, views=3):
    """Rays of a few camera bundles dominant along ``axis``: origins
    outside the box, directions tilted per bundle, jittered per ray."""
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    d = np.zeros((n, 3), np.float32)
    for v, sl in enumerate(np.array_split(np.arange(n), views)):
        o[sl] = [0.3 * (v - 1), -0.2 * v, 3.0]
        ang = rng.uniform(-spread, spread, (len(sl), 2))
        d[sl] = np.stack([np.tan(ang[:, 0]) + 0.2 * (v - 1),
                          np.tan(ang[:, 1]) - 0.1 * v,
                          -np.ones(len(sl))], -1)
    perm = rng.permutation(n)
    return (np.roll(o[perm], axis - 2, 1).astype(np.float32),
            np.roll(d[perm], axis - 2, 1).astype(np.float32))


def _assert_same(a, b):
    assert list(a) == list(b)
    for k in a:
        assert len(a[k]) == len(b[k]), k
        for x, y in zip(a[k], b[k]):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=str(k))


@pytest.mark.parametrize("axis", [0, 2])
def test_tile_buckets_match_jax(axis):
    o, d = _fan_rays(1, 4096 + 300, axis)
    args = (o, d, XYZ_MIN, XYZ_MAX, WORLD, axis)
    kw = dict(tile_n=256, widths=(16, 24, 32))
    _assert_same(torch_sweep.build_tile_buckets(*args, **kw),
                 jax_sweep.build_tile_buckets(*args, **kw))


@pytest.mark.parametrize("clip", [False, True])
def test_ray_segments_1d_match_jax(clip):
    o, d = _fan_rays(2, 8 * 1024 + 77, 1)
    box = (3.0, 36.0, 5.0, 50.0) if clip else None
    args = (o, d, XYZ_MIN, XYZ_MAX, WORLD, 1)
    kw = dict(n_rand=1024, tile_n=256, widths=(16, 24, 32, 48),
              clip_box=box)
    out = torch_sweep.build_ray_segments(*args, **kw)
    assert any(k for k in out)
    _assert_same(out, jax_sweep.build_ray_segments(*args, **kw))


@pytest.mark.parametrize("clip", [None, "p", "box6"])
@pytest.mark.parametrize("axis", [1, 2])
def test_ray_segments_2d_match_jax(axis, clip):
    o, d = _fan_rays(3, 12 * 512 + 33, axis, spread=0.05)
    box = {None: None, "p": (4.0, 40.0),
           "box6": (4.0, 40.0, 6.0, 30.0, 2.0, 34.0)}[clip]
    args = (o, d, XYZ_MIN, XYZ_MAX, WORLD, axis)
    kw = dict(n_rand=512, widths=(8, 16, 24, 32), max_classes=3,
              clip_box=box)
    out = torch_sweep.build_ray_segments_2d(*args, **kw)
    assert any(k != (0, 0) for k in out)
    _assert_same(out, jax_sweep.build_ray_segments_2d(*args, **kw))


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("n_blocks", [3, 6])
def test_ray_segments_blocked_match_jax(n_blocks, clip):
    o, d = _fan_rays(4, 10 * 512 + 5, 0, spread=0.15)
    box = (2.0, 45.0, 3.0, 36.0, 4.0, 50.0) if clip else None
    args = (o, d, XYZ_MIN, XYZ_MAX, WORLD, 0)
    kw = dict(n_rand=512, n_blocks=n_blocks, widths=(8, 16, 24, 32),
              max_classes=4, clip_box=box)
    out = torch_sweep.build_ray_segments_blocked(*args, **kw)
    assert any(k != (0, 0) for k in out)
    assert all(v[1].shape[1] == len(jax_sweep.blocked_p_rows(WORLD[0],
                                                             n_blocks))
               for v in out.values())
    _assert_same(out, jax_sweep.build_ray_segments_blocked(*args, **kw))


@pytest.mark.parametrize("gp", [2, 3, 17, 128, 257])
@pytest.mark.parametrize("n_blocks", [1, 4, 6])
def test_blocked_p_rows_match_jax(gp, n_blocks):
    rows = torch_sweep.blocked_p_rows(gp, n_blocks)
    assert rows == jax_sweep.blocked_p_rows(gp, n_blocks)
    assert rows[0][0] == 0 and rows[-1][1] == gp - 1


def _jax_rebucket(keep, g, o, d, n_rand, box6, widths2d, n_blocks):
    """The JAX engine's remainder steps (``build_buckets``), spelled out
    with the JAX package's functions."""
    rk0 = ("fblk", 0, 0, 0)
    rr = np.asarray(keep[rk0]).reshape(-1)
    if rr.size < n_rand:
        pad = np.random.default_rng(0).choice(g, size=n_rand - rr.size)
        rr = np.concatenate([rr, pad])
    b2 = jax_sweep.build_ray_segments_2d(
        o[rr], d[rr], XYZ_MIN, XYZ_MAX, WORLD, 2, n_rand=n_rand,
        widths=widths2d, max_classes=3, clip_box=box6)
    if b2:
        keep.pop(rk0, None)
        for wuv, (idx2, ulo, vlo) in b2.items():
            if idx2.shape[0] == 0:
                continue
            if wuv == (0, 0):
                keep[rk0] = rr[idx2].reshape(-1, 512)
            else:
                keep[wuv] = (rr[idx2], ulo, vlo)
    lf = keep.get(rk0)
    if lf is not None and lf.size > 0:
        lff = np.asarray(lf).reshape(-1)
        bb = jax_sweep.build_ray_segments_blocked(
            o[lff], d[lff], XYZ_MIN, XYZ_MAX, WORLD, 2, n_rand=n_rand,
            n_blocks=n_blocks, widths=(32, 48, 64, 96), max_classes=4,
            clip_box=box6)
        if bb:
            keep.pop(rk0, None)
            for wuv, (bi, uo, vo) in bb.items():
                if bi.shape[0] == 0:
                    continue
                if wuv == (0, 0):
                    keep[rk0] = lff[bi].reshape(-1, 512)
                else:
                    keep[("blk", *wuv)] = (lff[bi], uo, vo)
    return keep


@pytest.mark.parametrize("n_tiles,widths2d", [(1, (16, 24, 32)),
                                              (9, (16, 24, 32)),
                                              (9, (4,))])
def test_remainder_rebucket_matches_jax(n_tiles, widths2d):
    """The remainder of one tile (512 rays, padded up to a 1024-ray
    segment from the group) and of nine (whole segments and a tail), the
    latter once with 2D windows too narrow for any segment, so that the
    blocked buckets take them."""
    o, d = _fan_rays(5, 12 * 512, 2, spread=0.05, views=4)
    g = np.arange(o.shape[0])[::-1].copy()        # the group's pool indices
    # the remainder: the rays of one tilt, so that windows can fit
    rem = g[np.argsort(d[g, 0], kind="stable")][:n_tiles * 512]
    box6 = (2.0, 53.0, 4.0, 44.0, 1.0, 38.0)
    args = (1024, box6, widths2d, 6)

    def keep():
        return {("fblk", 32, 16, 1): g[:1024].reshape(2, 512),
                ("fblk", 0, 0, 0): rem.reshape(-1, 512)}

    got = torch_draws.rebucket_remainder(
        keep(), g, o, d, XYZ_MIN, XYZ_MAX, WORLD, 2, 1024, box6,
        widths2d=widths2d, n_blocks=6)
    want = _jax_rebucket(keep(), g, o, d, *args)
    if n_tiles > 1:       # a window class took remainder rays
        kinds = {"blk" if k[0] == "blk" else len(k) for k in got}
        assert ("blk" if widths2d == (4,) else 2) in kinds
    assert list(got) == list(want)
    for k in got:
        if isinstance(got[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            _assert_same({k: got[k]}, {k: want[k]})
