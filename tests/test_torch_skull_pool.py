"""``configs/skull.toml`` through the port's ``train`` command on the CPU:
Skull, four players, the MLP 256x3 relu against the opponent pool
(fraction 0.3), as users run it, cut to 8 envs x 16 steps. The opponents'
forward (K7's plain version on the CPU) runs MLP towers on Skull's obs."""

import json

import numpy as np

from burn_ppo_torch import cli

UPDATES = 8
PER_UPDATE = 8 * 16


def test_train_command_trains_skull_mlp_against_the_pool_on_cpu(tmp_path):
    run = tmp_path / "run"
    rc = cli.main(
        ["train", "--config", "configs/skull.toml", "--num-envs", "8", "--num-steps", "16",
         "--total-steps", str(UPDATES * PER_UPDATE), "--log-freq", str(PER_UPDATE),
         "--checkpoint-freq", str(PER_UPDATE), "--seed", "2", "--run-dir", str(run), "--quiet"],
        device="cpu",
    )
    assert rc == 0
    series: dict = {}
    for line in (run / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["type"] == "scalar":
            assert np.isfinite(rec["value"]), rec
            series.setdefault(rec["name"], []).append(rec["value"])
    assert len(series["train/policy_loss"]) == UPDATES
    # From update 2 on, the two pool envs seat the learner on one of four seats.
    assert all(0.0 < v < 1.0 for v in series["train/learner_valid_fraction"][1:])

    ckpts = run / "checkpoints"
    steps = [f"step_{u * PER_UPDATE:08d}" for u in range(1, UPDATES + 1)]
    assert sorted(p.name for p in ckpts.iterdir() if p.name.startswith("step_")) == steps
    assert (ckpts / "latest").resolve().name == steps[-1]
    meta = json.loads((ckpts / "latest" / "metadata.json").read_text())
    assert (meta["network_type"], meta["hidden_size"], meta["num_hidden"], meta["activation"],
            meta["num_players"], meta["obs_dim"], meta["action_count"]) == (
        "mlp", 256, 3, "relu", 4, 135, 33)

    pool = json.loads((run / "opponent_stats.json").read_text())["opponents"]
    # The stats file is written after each update's results fold, before
    # that update's checkpoint joins the pool.
    assert [o["name"] for o in pool] == steps[:-1]
    assert sum(o["games_played"] for o in pool) > 0
    games = (run / "rating_games.jsonl").read_text().splitlines()
    assert games and series["train/rating_games"][-1] > 0
    assert (run / "rating_metadata.json").exists()
