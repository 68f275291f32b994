"""The colour MLP's initial weights. The JAX models draw theirs from
``PRNGKey(seed)``, ``seed`` being a model keyword (0 in every config), so
the JAX engine starts every ``--seed`` from one MLP and ``--seed`` picks
only the rays. The port draws from a generator seeded by the same keyword:
a model built twice with one ``seed`` starts from one MLP, whatever the
process's random state, and ``run.py --seed`` leaves it alone.
"""

import os

import pytest
import torch

from directvoxgo_tpu_torch import run as torch_run
from directvoxgo_tpu_torch.engine import train as train_lib
from directvoxgo_tpu_torch.models.dmpigo import DirectMPIGO
from directvoxgo_tpu_torch.models.dvgo import DirectVoxGO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "synthetic", "fixture_tiny.py")

MODELS = {
    "dvgo": (DirectVoxGO, dict(
        xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1], num_voxels=16 ** 3,
        num_voxels_base=16 ** 3, alpha_init=1e-2, rgbnet_dim=6,
        rgbnet_depth=3, rgbnet_width=24, k_color=0)),
    "dmpigo": (DirectMPIGO, dict(
        xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1], num_voxels=16 * 16 * 8,
        mpi_depth=8, rgbnet_dim=6, rgbnet_depth=3, rgbnet_width=24,
        viewbase_pe=2, k_color=0)),
}


def _weights(model):
    return [p.detach().clone() for p in model.rgbnet.parameters()]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_mlp_starts_from_the_seed_keyword(name):
    cls, kw = MODELS[name]
    torch.manual_seed(1)
    a = _weights(cls(**kw, seed=0, device="cpu"))
    torch.manual_seed(2)
    b = _weights(cls(**kw, seed=0, device="cpu"))
    c = _weights(cls(**kw, seed=3, device="cpu"))
    assert _same(a, b), "one seed keyword, two initial MLPs"
    assert not _same(a, c), "two seed keywords, one initial MLP"


class _Built(Exception):
    pass


def _initial_fine_mlp(tmp_path, seed, monkeypatch):
    """The fine stage's MLP as ``run.py`` builds it with ``--seed``: the
    optimizer's constructor is stopped at the first model with an MLP."""
    real = train_lib.create_optimizer_or_freeze_model
    built = []

    def grab(model, cfg_train):
        if model.has_rgbnet:
            built.append(_weights(model))
            raise _Built
        return real(model, cfg_train)

    monkeypatch.setattr(train_lib, "create_optimizer_or_freeze_model", grab)
    cfg = tmp_path / f"tiny_{seed}.py"
    cfg.write_text(f"_base_ = {TINY!r}\nexpname = 'tiny_{seed}'\n"
                   f"basedir = {str(tmp_path / 'logs')!r}\n"
                   "coarse_train = {'N_iters': 2, 'N_rand': 128}\n")
    with pytest.raises(_Built):
        torch_run.main(["--config", str(cfg), "--seed", str(seed),
                        "--no_reload", "--device", "cpu"])
    return built[0]


def test_run_seed_leaves_the_initial_mlp_alone(tmp_path, monkeypatch):
    """``--seed 1`` and ``--seed 2`` start the fine stage from one MLP."""
    one = _initial_fine_mlp(tmp_path, 1, monkeypatch)
    two = _initial_fine_mlp(tmp_path, 2, monkeypatch)
    assert _same(one, two)
