"""The port's opponent pool, its game records and its ratings against the
JAX package's: the same rotations for a seed, the same EMA win rates and
``opponent_stats.json`` after the same records, the same record rows out
of the same pool-env logs, and the same Plackett-Luce ratings from the
same games; and the rotation stacked on the device from the run's own
checkpoints."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.selfplay.opponent_pool import OpponentPool as JaxPool  # noqa: E402
from burn_ppo_tpu.selfplay.rating_history import RatingHistory as JaxRatings  # noqa: E402
from burn_ppo_tpu.train import extract_pool_records as jax_extract  # noqa: E402
from burn_ppo_torch.checkpoint import CheckpointManager, build_metadata, model_leaves  # noqa: E402
from burn_ppo_torch.models.network import ActorCriticNetwork  # noqa: E402
from burn_ppo_torch.ppo.normalization import ObsNormState  # noqa: E402
from burn_ppo_torch.ppo.pool_rollout import actor_params  # noqa: E402
from burn_ppo_torch.selfplay.opponent_pool import OpponentPool, _fill_missing_norms  # noqa: E402
from burn_ppo_torch.selfplay.rating_history import RatingHistory  # noqa: E402
from burn_ppo_torch.train import extract_pool_records  # noqa: E402

STEPS = [64, 128, 192, 256, 320, 384, 448, 512, 576, 640, 704]


def _pools(tmp_path, max_active=8, seed=3, exponent=2.0):
    """Both pools over the same run directory layout (empty step dirs)."""
    pools = []
    for side in ("torch", "jax"):
        run = tmp_path / side
        for s in STEPS:
            (run / "checkpoints" / f"step_{s:08d}").mkdir(parents=True)
        cls = OpponentPool if side == "torch" else JaxPool
        pools.append(cls(run, select_alpha=0.1, select_exponent=exponent, max_active=max_active,
                         seed=seed))
    return pools


def _records(rng, n, P, K):
    learner = rng.integers(1, P + 1, n)
    slots = rng.integers(-1, K + 1, (n, P - 1))  # out-of-range slots are dropped
    places = rng.integers(1, P + 1, (n, P - 1))
    return learner.astype(np.int32), slots.astype(np.int32), places.astype(np.int32)


@pytest.mark.parametrize("max_active,exponent", [(8, 2.0), (3, 1.0), (20, 3.0)])
def test_rotations_win_rates_and_stats_file_match_jax(tmp_path, max_active, exponent):
    mine, ref = _pools(tmp_path, max_active, seed=max_active, exponent=exponent)
    assert len(mine) == len(ref) == len(STEPS)
    rng = np.random.default_rng(max_active)
    for rotation in range(6):
        a, b = mine.sample_active(), ref.sample_active()
        assert a == b, rotation
        for P in (2, 3):
            rows = _records(rng, 40, P, len(a))
            mine.queue_game_results_batch(a, *rows)
            ref.queue_game_results_batch(b, *rows)
        # The per-game path folds into the same queues.
        mine.queue_game_result(a[:1], 1, [2])
        ref.queue_game_result(b[:1], 1, [2])
        mine.apply_pending_updates()
        ref.apply_pending_updates()
        assert mine.selection_weights() == ref.selection_weights()
        best = a[0]
        assert mine.get_pool_performance(best) == ref.get_pool_performance(best)
    assert mine.get_pool_performance(None) is None and ref.get_pool_performance(None) is None
    assert (mine.stats_path.read_text() == ref.stats_path.read_text())
    rates = [s["win_rate"] for s in json.loads(mine.stats_path.read_text())["opponents"]]
    assert len(set(rates)) > 2  # the records moved the rates apart
    # A pool restarted on the run reads the stats back and drops entries
    # whose checkpoint is gone.
    gone = mine.ckpt_dir / f"step_{STEPS[0]:08d}"
    gone.rmdir()
    again = OpponentPool(mine.run_dir, seed=1)
    assert len(again) == len(STEPS) - 1
    assert again.stats[a[-1]].win_rate == mine.stats[a[-1]].win_rate or a[-1] == gone.name


@pytest.mark.parametrize("P", [2, 3])
def test_extract_pool_records_matches_jax(P):
    rng = np.random.default_rng(P)
    T, Ep = 8, 12
    rec = dict(
        completed=rng.random((T, Ep)) < 0.3,
        outcome=rng.integers(0, P + 1, (T, Ep, P)).astype(np.int32),
        learner_seat=rng.integers(-1, P, (T, Ep)).astype(np.int32),
        seat_opp=rng.integers(0, 8, (T, Ep, P)).astype(np.int32),
    )
    ref = jax_extract(SimpleNamespace(**rec), P)
    mine = extract_pool_records(SimpleNamespace(**{**rec, "completed": rec["completed"] * 1.0}), P)
    assert ref.shape[0] > 5
    np.testing.assert_array_equal(mine, ref)
    empty = {**rec, "completed": np.zeros((T, Ep))}
    assert extract_pool_records(SimpleNamespace(**empty), P).shape == (0, 2 * P - 1)


def test_plackett_luce_ratings_match_jax(tmp_path):
    """The same checkpoints and vs-pool games through both rating
    histories: the snapshot, every rating to 1e-9, and the files."""
    rng = np.random.default_rng(0)
    hists = [RatingHistory.load(tmp_path / "t"), JaxRatings.load(tmp_path / "j")]
    (tmp_path / "t").mkdir(exist_ok=True)
    (tmp_path / "j").mkdir(exist_ok=True)
    names = [f"step_{s:08d}" for s in STEPS[:7]]
    snaps = []
    for i, name in enumerate(names):
        for h in hists:
            h.on_checkpoint_saved(name, STEPS[i])
        active = names[:i + 1][-4:]
        learner = rng.integers(1, 3, 60)
        slots = rng.integers(0, len(active), (60, 1))
        opp = np.where(learner == 1, rng.integers(1, 3, 60), 1)[:, None]  # draws and wins
        for h in hists:
            h.record_games_arrays(name, active, learner, slots, opp)
        snaps.append([h.compute() for h in hists])
    for a, b in snaps:
        for f in ("current_elo", "best_elo"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=0, atol=1e-9)
        assert (a.best_step, a.total_games) == (b.best_step, b.total_games)
    np.testing.assert_allclose(hists[0]._cached_ratings, hists[1]._cached_ratings, rtol=0,
                               atol=1e-9)
    assert len(set(np.round(hists[0]._cached_ratings, 3))) > 3
    for f in ("rating_games.jsonl", "rating_metadata.json"):
        assert (tmp_path / "t" / f).read_text() == (tmp_path / "j" / f).read_text()
    # Reloaded from its files, the port's history computes the same.
    back = RatingHistory.load(tmp_path / "t").compute()
    np.testing.assert_allclose(back.best_elo, snaps[-1][0].best_elo, rtol=0, atol=1e-9)
    assert back.best_step == snaps[-1][0].best_step


def test_rating_graph_is_guarded(tmp_path, monkeypatch):
    """Without matplotlib the graphs return False and raise nothing."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    h = RatingHistory.load(tmp_path)
    h.on_checkpoint_saved("step_00000064", 64)
    h.record_games_arrays("step_00000064", ["step_00000064"], np.array([1]), np.array([[0]]),
                          np.array([[2]]))
    pool = OpponentPool(tmp_path)
    pool.add_checkpoint("step_00000064", 64)
    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    assert h.generate_graph(tmp_path / "elo.png") is False
    assert pool.generate_selection_graph(tmp_path / "sel.png") is False
    assert not (tmp_path / "elo.png").exists()


def _save(run, step, net, norm):
    meta = build_metadata(step=step, env_name="connect_four", network=net, num_players=2,
                          normalize_obs=norm is not None)
    extra = {"obs_norm": None if norm is None else [norm.mean, norm.m2, norm.count],
             "return_norm": []}
    return CheckpointManager(run).save(step, model_leaves(net), [], extra, meta)


def test_refresh_rotation_stacks_the_checkpoints_padded_to_k(tmp_path):
    nets, norms = [], []
    for i, step in enumerate((64, 128, 192)):
        net = ActorCriticNetwork(86, 7, hidden_size=16, num_hidden=2, activation="tanh",
                                 generator=torch.Generator().manual_seed(i))
        norm = None if i == 1 else ObsNormState(mean=torch.full((86,), 0.1 * i),
                                                m2=torch.full((86,), 3.0 + i),
                                                count=torch.tensor(10.0 + i))
        _save(tmp_path, step, net, norm)
        nets.append(net)
        norms.append(norm)
    pool = OpponentPool(tmp_path, max_active=2, seed=0)
    stack, names = pool.refresh_rotation(pad_to=5)
    assert len(names) == 2 and stack.num_slots == 5 and stack.activation == "tanh"
    order = [int(n[5:]) // 64 - 1 for n in names] + [int(names[0][5:]) // 64 - 1] * 3
    assert [w.shape for w in stack.weights] == [(5, 86, 16), (5, 16, 16), (5, 16, 7)]
    for slot, i in enumerate(order):
        ref = actor_params(nets[i])
        for w, b, rw, rb in zip(stack.weights, stack.biases, ref.weights, ref.biases):
            torch.testing.assert_close(w[slot], rw, rtol=0, atol=0)
            torch.testing.assert_close(b[slot], rb, rtol=0, atol=0)
        # A checkpoint saved without a normaliser stacks as the identity (count 0).
        want = norms[i] if norms[i] is not None else ObsNormState.create(86, torch.device("cpu"))
        if any(norms[j] is not None for j in order):
            torch.testing.assert_close(stack.norm.count[slot], want.count.reshape(()))
            torch.testing.assert_close(stack.norm.mean[slot], want.mean)
    # The live learner seeds the cache with a snapshot the update cannot touch.
    live = nets[0]
    pool.add_checkpoint("step_00000256", 256)
    pool.seed_device_cache("step_00000256", live, None)
    entry = pool._load_params_device("step_00000256")
    with torch.no_grad():
        for prm in live.parameters():
            prm.add_(1.0)
    torch.testing.assert_close(entry[0].weights[0], actor_params(nets[0]).weights[0] - 1.0)
    assert _fill_missing_norms([None, None]) == [None, None]
