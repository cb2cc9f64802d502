"""The port's package boundary: no JAX, no silent CPU, CPU tensors take
the plain path of every kernel wrapper."""

import ast
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
from burn_ppo_torch.envs.skull import Skull, skull_step_autoreset  # noqa: E402
from burn_ppo_torch.ops.categorical import masked_sample  # noqa: E402
from burn_ppo_torch.ops.gae import compute_gae, compute_gae_multiplayer  # noqa: E402
from burn_ppo_torch.envs.base import EpisodeLog  # noqa: E402
from burn_ppo_torch.ppo.episode_stats import summarize_episode_logs  # noqa: E402
from burn_ppo_torch.ppo.normalization import (  # noqa: E402
    ObsNormState,
    ReturnNormState,
    obs_norm_apply,
    obs_norm_update,
    return_norm_finalize,
    return_norm_roll,
)
from burn_ppo_torch.ppo.pool_rollout import OpponentStack, opponent_actor_forward  # noqa: E402
from burn_ppo_torch.ppo.update import PPOUpdateConfig, clip_adam, ppo_loss  # noqa: E402

WRAPPERS = (cartpole_step_autoreset, connect_four_step_autoreset, masked_sample, compute_gae,
            compute_gae_multiplayer, obs_norm_apply, obs_norm_update, opponent_actor_forward,
            ppo_loss, clip_adam, summarize_episode_logs, skull_step_autoreset, return_norm_roll,
            return_norm_finalize)

REPO = Path(__file__).resolve().parent.parent


def test_every_module_imports_with_jax_blocked():
    # A subprocess: conftest has already imported jax into this one.
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax", "burn_ppo_tpu"):
            sys.modules[name] = None
        import burn_ppo_torch
        names = ["burn_ppo_torch"]
        for m in pkgutil.walk_packages(burn_ppo_torch.__path__, "burn_ppo_torch."):
            if m.name != "burn_ppo_torch.__main__":
                names.append(m.name)
        for n in names:
            importlib.import_module(n)
        leaked = sorted(k for k in sys.modules
                        if k.split(".")[0] in ("jax", "flax", "optax", "burn_ppo_tpu")
                        and sys.modules[k] is not None)
        assert not leaked, leaked
        print(len(names))
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 30  # every module was walked


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_of_the_port_or_chip_smoke_imports_jax_or_the_jax_package():
    """Every import statement, also those inside functions, that the
    subprocess above would not reach."""
    files = sorted((REPO / "burn_ppo_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 30
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "flax", "optax", "burn_ppo_tpu"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


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
    stack = OpponentStack(weights=[torch.ones(3, 5, 4), torch.ones(3, 4, 2)],
                          biases=[torch.zeros(3, 4), torch.zeros(3, 2)], activation="tanh")
    assert opponent_actor_forward(torch.ones(E, 5), torch.zeros(E, dtype=torch.int32),
                                  stack).shape == (E, 2)
    mb = {"actions": torch.zeros(E, dtype=torch.int32), "old_log_probs": torch.zeros(E),
          "advantages": torch.arange(E, dtype=torch.float32), "returns": torch.zeros(E),
          "old_values": torch.zeros(E), "valid": torch.ones(E)}
    loss, metrics = ppo_loss(torch.zeros(E, 2), torch.zeros(E), mb, 0.01, PPOUpdateConfig())
    assert loss.shape == () and metrics.shape == (14,)
    params = torch.ones(6)
    clip_adam(params, torch.ones(6), torch.zeros(6), torch.zeros(6), lr=0.1, max_grad_norm=0.5,
              eps=1e-5, bc1=0.1, bc2=0.001)
    assert bool(torch.all(params < 1.0))
    logs = EpisodeLog(completed=torch.ones(2, E), total_rewards=torch.zeros(2, E, 2),
                      length=torch.ones(2, E, dtype=torch.int32),
                      outcome=torch.ones(2, E, 2, dtype=torch.int32),
                      active_players=torch.full((2, E), 2, dtype=torch.int32))
    assert float(summarize_episode_logs(logs, 2, num_envs=3)["count"]) == 6
    sk = Skull(4)
    out = sk.step_autoreset(sk.reset(torch.empty(E, 0)), EpisodeAccumulator.zero(E, 4, cpu),
                            torch.full((E,), 1, dtype=torch.int32), torch.empty(E, 0),
                            torch.full((E,), 0.5))
    assert out.obs.shape == (E, 135) and out.mask.shape == (E, 33) and out.priv.shape == (E, 200)
    ret, samples = return_norm_roll(torch.zeros(E, 4), torch.ones(E),
                                    torch.zeros(E, dtype=torch.int32), torch.zeros(E), 0.99)
    assert ret.shape == (E, 4) and samples.shape == (E,)
    rn, norm_r = return_norm_finalize(ReturnNormState.create(E, 4, cpu), torch.ones(3, E),
                                      torch.ones(3, E))
    assert norm_r.shape == (3, E) and float(rn.count) == 3 * E
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
        "gae_multiplayer.cu", "obs_norm.cu", "opponent_actor.cu", "ppo_loss.cu", "clip_adam.cu",
        "episode_stats.cu", "skull_step.cu", "return_norm.cu",
    }
    assert {name for name in kernels.SIGNATURES} >= {
        "opp_slot_sort", "opp_grouped_dense", "ppo_loss_forward", "clip_adam", "episode_stats",
        "skull_step_autoreset", "return_norm_roll", "return_norm_finalize"}
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)
    assert "--use_fast_math" not in kernels.NVCC_FLAGS
