"""The tournament front end against the JAX package: the host functions
(Swiss points, Dutch pods with floaters and repeat avoidance, round robin,
match scoring, the anchor, discovery on run dirs, display names,
checkpoint selection) on the same inputs, and ``tournament`` through
``cli.main(..., device="cpu")``: a greedy round robin on the Connect Four
gauntlet equal to JAX's, a Swiss field with a bye, and the refusals."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import burn_ppo_tpu.tournament as jt  # noqa: E402
from burn_ppo_torch import cli  # noqa: E402
from burn_ppo_torch import tournament as tt  # noqa: E402
from burn_ppo_torch.checkpoint import CheckpointManager, build_metadata, model_leaves  # noqa: E402
from burn_ppo_torch.models.network import ActorCriticNetwork  # noqa: E402

GAUNTLET = Path(__file__).resolve().parent.parent / "gauntlet"
C4 = GAUNTLET / "connect_four"


def test_swiss_points_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(0, 7))
        placements = [int(x) for x in rng.integers(1, n + 1, n)] if n else []
        assert tt.calculate_swiss_points(placements) == jt.calculate_swiss_points(placements)


def fields(rng, n, played):
    """Random contestant states, the same for both packages."""
    out = []
    for i in range(n):
        pts = float(rng.integers(0, 4)) * 0.5 if played else 0.0
        faced = {int(x) for x in rng.choice(n, int(rng.integers(0, min(n, 4))), replace=False)} - {i}
        out.append(dict(name=f"c{i}", path=Path(f"/runs/c{i}") if i else None,
                        step=int(rng.integers(0, 1000)), initial_seed=float(rng.permutation(n)[i]),
                        swiss_points=pts, opponents_faced=faced))
    return ([jt.Contestant(source=None, **f) for f in out],
            [tt.Contestant(source=None, **f) for f in out])


@pytest.mark.parametrize("pod_size", [2, 3, 4])
def test_dutch_pods_floaters_and_repeat_avoidance_match_jax(pod_size):
    rng = np.random.default_rng(pod_size)
    swaps = 0
    for trial in range(60):
        n = int(rng.integers(pod_size, 13))
        jc, tc = fields(rng, n, played=trial % 3 != 0)
        ranked = [int(x) for x in rng.permutation(n)]
        j_pods, j_left = jt.form_dutch_pods_with_floaters(list(ranked), pod_size, jc)
        t_pods, t_left = tt.form_dutch_pods_with_floaters(list(ranked), pod_size, tc)
        assert (t_pods, t_left) == (j_pods, j_left)
        k = n // pod_size
        naive = [[ranked[i + g * k] for g in range(pod_size)] for i in range(k)]
        swaps += t_pods != naive  # a swap avoided a repeat opponent
        idx = sorted(int(x) for x in rng.choice(n, int(rng.integers(pod_size, n + 1)), replace=False))
        for indices in (None, idx):
            assert tt.swiss_pods(tc, pod_size, indices) == jt.swiss_pods(jc, pod_size, indices)
    assert swaps > 0
    assert tt.round_robin_pods(6, pod_size) == jt.round_robin_pods(6, pod_size)


def test_update_stats_and_anchor_match_jax():
    rng = np.random.default_rng(3)
    for P in (2, 3, 4):
        jc, tc = fields(rng, 7, played=True)
        for _ in range(20):
            pod = [int(x) for x in rng.choice(7, P, replace=False)]
            games = [[int(x) for x in rng.integers(1, P + 1, P)] for _ in range(int(rng.integers(0, 5)))]
            jt.update_stats_from_games(jc, pod, games)
            tt.update_stats_from_games(tc, pod, games)
        for a, b in zip(tc, jc):
            assert (a.swiss_points, a.games_played, a.draw_count, a.placement_counts,
                    a.opponents_faced) == (b.swiss_points, b.games_played, b.draw_count,
                                           b.placement_counts, b.opponents_faced)
        assert tt.find_anchor_index(tc) == jt.find_anchor_index(jc)
        tc[3].name = jc[3].name = "Random"
        assert tt.find_anchor_index(tc) == jt.find_anchor_index(jc) == 3


def test_display_names_and_evenly_spaced_match_jax():
    cases = [
        [Path("/a/runs/x/checkpoints/step_1"), Path("/a/runs/y/checkpoints/step_2")],
        [Path("/a/b/c"), Path("/a/b/d"), Path("/a/e/c")],
        [Path("r1/step_5")],
        [Path("/g/connect_four/r4"), Path("/g/connect_four/r4_mid"), Path("/h/skull/r4")],
        [],
    ]
    for paths in cases:
        assert tt.compute_display_names(paths) == jt.compute_display_names(paths)
    items = [Path(f"s{i}") for i in range(11)]
    for n in range(0, 13):
        assert tt.select_evenly_spaced(items, n) == jt.select_evenly_spaced(items, n)


def tiny_run(root, name, steps, env="connect_four", returns=None, best=None, hidden=8):
    """A run dir of tiny Connect Four MLP checkpoints written by the port."""
    mgr = CheckpointManager(root / name)
    for i, step in enumerate(steps):
        net = ActorCriticNetwork(86, 7, hidden_size=hidden, num_hidden=1, activation="tanh",
                                 generator=torch.Generator().manual_seed(step))
        meta = build_metadata(step=step, env_name=env, network=net,
                              num_players=1 if returns is not None else 2,
                              avg_return=returns[i] if returns is not None else 0.0)
        mgr.save(step, model_leaves(net), [], {}, meta)
    if best is not None:
        mgr.set_best(best)
    return root / name


def test_discovery_on_run_dirs_matches_jax(tmp_path):
    """Run dirs (best, latest, evenly spaced, --limit-per-run), a
    checkpoints dir, a checkpoint dir, the seeding of one training run and
    the shuffled seeding of several, Random last."""
    a = tiny_run(tmp_path, "a", [10, 20, 30, 40, 50, 60, 70], best=30)
    b = tiny_run(tmp_path, "b", [5, 15, 25], returns=[1.0, 3.0, 2.0])
    c = tiny_run(tmp_path, "c", [7, 8])
    assert tt.get_best_checkpoint(a / "checkpoints") == jt.get_best_checkpoint(a / "checkpoints")
    assert tt.get_best_checkpoint(b / "checkpoints") == jt.get_best_checkpoint(b / "checkpoints")
    assert tt.get_best_checkpoint(c / "checkpoints") == jt.get_best_checkpoint(c / "checkpoints")
    ck = a / "checkpoints"
    for limit in (0, 1, 2, 4, 9):
        got = tt.select_checkpoints_with_priority(ck, tt.enumerate_checkpoints(ck), limit)
        assert got == jt.select_checkpoints_with_priority(ck, jt.enumerate_checkpoints(ck), limit)
    cases = [
        ([a], dict(limit_per_run=3, include_random=True)),
        ([b], dict()),
        ([a, b / "checkpoints", c / "checkpoints" / "step_00000008"],
         dict(limit_per_run=2, include_random=True, shuffle_seed=4)),
        ([c, b], dict(shuffle_seed=1)),
    ]
    for srcs, kw in cases:
        j = jt.discover_contestants(srcs, **kw)
        t = tt.discover_contestants(srcs, device="cpu", **kw)
        assert [(x.name, x.path, x.step, x.initial_seed, x.source.kind) for x in t] == [
            (x.name, x.path, x.step, x.initial_seed, x.source.kind) for x in j]
    with pytest.raises(FileNotFoundError):
        tt.discover_contestants([tmp_path / "nothing"], device="cpu")


def tournament(*argv):
    return cli.main(["tournament", *map(str, argv)], device="cpu")


def test_greedy_round_robin_on_the_gauntlet_equals_jax(tmp_path, capsys):
    """r4, r4_mid and Random, greedy (Random's greedy move is its last
    legal column): every game is deterministic, so the port's standings,
    points and ratings are JAX's. The JSON has JAX's keys."""
    out = tmp_path / "port.json"
    kw = dict(num_games=6, num_envs=4, include_random=True, temp=0.0, temp_cutoff=10,
              temp_final=0.0, seed=0)
    j = jt.run_tournament([C4 / "r4", C4 / "r4_mid"], quiet=True, **kw)
    assert tournament(C4 / "r4", C4 / "r4_mid", "--random", "-n", 6, "--num-envs", 4, "--temp",
                      0, "--temp-cutoff", 10, "--temp-final", 0, "--seed", 0, "-o", out) == 0
    t = json.loads(out.read_text())
    printed = capsys.readouterr().out
    assert "Round-Robin" in printed and "Final standings" in printed
    reference = json.loads((C4 / "ratings_r4.json").read_text())
    assert set(t) == set(j) == set(reference)
    assert [set(r) for r in t["rankings"]] == [set(r) for r in j["rankings"]]
    for key in ("env", "num_players", "format", "rounds", "total_games", "converged"):
        assert t[key] == j[key], key
    assert t["config"] == j["config"]
    assert [{k: r[k] for k in r if k != "source"} for r in t["rankings"]] == [
        {k: r[k] for k in r if k != "source"} for r in j["rankings"]]
    assert [dict(p, logits=None) for p in t["pods"]] == [dict(p, logits=None) for p in j["pods"]]
    # r4 + r4_mid stacks for K7; each pod with Random is one model
    assert sorted(p["logits"] for p in t["pods"]) == ["single", "single", "stacked"]


def test_swiss_odd_field_gives_a_bye(tmp_path, capsys):
    """Ten tiny checkpoints of one run and Random: C(11, 2) > 50, so Swiss;
    each round one bye, worth a match win."""
    run = tiny_run(tmp_path, "swiss", list(range(100, 1100, 100)))
    out = tmp_path / "swiss.json"
    assert tournament(run, "--random", "-n", 2, "--num-envs", 2, "--rounds", 2, "--seed", 1,
                      "-o", out) == 0
    printed = capsys.readouterr().out
    res = json.loads(out.read_text())
    assert res["format"] == "swiss" and res["rounds"] == 2
    assert printed.count("receives bye (+1.0 points)") == 2
    assert len(res["pods"]) == 10 and all(p["games"] == 2 for p in res["pods"])
    assert len(res["rankings"]) == 11 and res["total_games"] == 20


def test_mixed_environments_and_missing_players_are_refused():
    with pytest.raises(ValueError, match="mixed environments"):
        tournament(C4 / "r4", GAUNTLET / "skull" / "r4", "-n", 2)
    with pytest.raises(ValueError, match="pass --players"):
        tournament(GAUNTLET / "skull" / "r4", "--random", "-n", 2)
    with pytest.raises(ValueError, match="at least 2"):
        tournament(C4 / "r4", "-n", 2)


def test_graphs_return_false_without_matplotlib(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    contestants = tt.discover_contestants([C4 / "r4"], include_random=True, device="cpu")
    result = tt.pl_compute_ratings(2, [tt.GameResult.of([0, 1], [1, 2])], 1)
    assert tt._generate_rating_graph(contestants, result, tmp_path / "r.png") is False
    assert tt._generate_points_graph(contestants, [[0.0, 0.0], [1.0, 0.0]],
                                     tmp_path / "p.png") is False
    assert tt._generate_points_graph(contestants, [[0.0, 0.0]], tmp_path / "p.png") is False
    assert jt._generate_points_graph(contestants, [[0.0, 0.0]], tmp_path / "p.png") is False
