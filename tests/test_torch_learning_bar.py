"""The CartPole learning bar on the port, on the CPU: an average return of
at least 195 within 200k steps, at the settings of
scripts/validate_cartpole.py (32 envs x 128 steps, tanh 64x2, lr 1e-3,
normalize_obs, seed 1)."""

import torch

torch.set_num_threads(1)

from burn_ppo_tpu.config import Config  # noqa: E402
from burn_ppo_tpu.schedule import Schedule  # noqa: E402
from burn_ppo_torch.train import Trainer  # noqa: E402


def test_cartpole_learning_bar_on_cpu(tmp_path):
    cfg = Config(
        env="cartpole", num_envs=32, num_steps=128, total_steps=200_000,
        learning_rate=Schedule.constant(1e-3), normalize_obs=True, hidden_size=64,
        num_hidden=2, activation="tanh", entropy_coef=Schedule.constant(0.01),
        checkpoint_freq=100_000, log_freq=8_192, seed=1, opponent_pool_fraction=0.0,
    )
    summary = Trainer(cfg, tmp_path / "run", device="cpu", quiet=True).train()
    assert summary["final_step"] >= 200_000
    assert summary["avg_return"] >= 195.0, summary
