"""The port's package boundary: no JAX, no silent CPU, CPU tensors take
the plain path of every kernel wrapper."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_torch import kernels  # noqa: E402
from burn_ppo_torch.device import resolve_device  # noqa: E402
from burn_ppo_torch.envs.base import EpisodeAccumulator  # noqa: E402
from burn_ppo_torch.envs.cartpole import CartPole, cartpole_step_autoreset  # noqa: E402
from burn_ppo_torch.envs.connect_four import ConnectFour, connect_four_step_autoreset  # noqa: E402
from burn_ppo_torch.ops.categorical import masked_sample  # noqa: E402
from burn_ppo_torch.ops.gae import compute_gae, compute_gae_multiplayer  # noqa: E402
from burn_ppo_torch.ppo.normalization import ObsNormState, obs_norm_apply, obs_norm_update  # noqa: E402

WRAPPERS = (cartpole_step_autoreset, connect_four_step_autoreset, masked_sample, compute_gae,
            compute_gae_multiplayer, obs_norm_apply, obs_norm_update)

REPO = Path(__file__).resolve().parent.parent


def test_every_module_imports_with_jax_blocked():
    # A subprocess: conftest has already imported jax into this one.
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax"):
            sys.modules[name] = None
        import burn_ppo_torch
        names = ["burn_ppo_torch"]
        for m in pkgutil.walk_packages(burn_ppo_torch.__path__, "burn_ppo_torch."):
            if m.name != "burn_ppo_torch.__main__":
                names.append(m.name)
        for n in names:
            importlib.import_module(n)
        leaked = sorted(k for k in sys.modules
                        if k.split(".")[0] in ("jax", "flax", "optax")
                        and sys.modules[k] is not None)
        assert not leaked, leaked
        print(len(names))
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20  # every module was walked


def test_resolve_device_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    rng = np.random.default_rng(0)
    before = [w.launches for w in WRAPPERS]
    cpu = torch.device("cpu")
    env = CartPole()
    E = 8
    state = env.reset(torch.from_numpy(rng.uniform(-0.05, 0.05, (E, 4)).astype(np.float32)))
    out = env.step_autoreset(
        state,
        EpisodeAccumulator.zero(E, 1, cpu),
        torch.zeros(E, dtype=torch.int32),
        torch.zeros(E, 4),
    )
    assert out.obs.shape == (E, 5) and out.rewards.shape == (E, 1)
    c4 = ConnectFour()
    out = c4.step_autoreset(c4.reset(torch.empty(E, 0)), EpisodeAccumulator.zero(E, 2, cpu),
                            torch.full((E,), 3, dtype=torch.int32), torch.empty(E, 0))
    assert out.obs.shape == (E, 86) and out.mask.shape == (E, 7)
    actions, logp = masked_sample(
        torch.zeros(E, 2), torch.ones(E, 2), torch.full((E, 2), 0.5)
    )
    assert actions.dtype == torch.int32 and logp.shape == (E,)
    adv, ret = compute_gae(torch.ones(4, E), torch.zeros(4, E), torch.zeros(4, E),
                           torch.zeros(E), 0.99, 0.95)
    assert adv.shape == ret.shape == (4, E)
    adv, ret = compute_gae_multiplayer(torch.ones(4, E, 2), torch.zeros(4, E), torch.zeros(4, E),
                                       torch.zeros(4, E, dtype=torch.int32), torch.zeros(E, 2),
                                       0.99, 0.95)
    assert adv.shape == ret.shape == (4, E)
    norm = obs_norm_update(ObsNormState.create(5, cpu), torch.ones(4, E, 5))
    assert obs_norm_apply(norm, torch.ones(E, 5)).shape == (E, 5)
    after = [w.launches for w in WRAPPERS]
    assert before == after == [0] * len(WRAPPERS)


def test_wrappers_refuse_mixed_and_unknown_devices():
    with pytest.raises(ValueError, match="mixed devices"):
        kernels.on_cpu(torch.zeros(1), torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        kernels.on_cpu(torch.zeros(1, device="meta"))


def test_kernel_library_is_content_addressed_under_the_repo_cache():
    path = kernels.library_path()
    assert path.parent == REPO / ".cache" / "burn_ppo_torch" / "kernels"
    assert {p.name for p in kernels.sources()} >= {
        "cartpole_step.cu", "masked_gumbel_sample.cu", "gae.cu", "connect_four_step.cu",
        "gae_multiplayer.cu", "obs_norm.cu",
    }
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)
    assert "--use_fast_math" not in kernels.NVCC_FLAGS
