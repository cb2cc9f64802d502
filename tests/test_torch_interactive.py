"""The port's Skull assistant (``burn_ppo_torch.interactive``) on the CPU:
the cases of tests/test_interactive.py against the port's server, the
gauntlet directory and the command line, and the port's app beside the
JAX package's on the committed ``gauntlet/skull/r4`` checkpoint."""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from burn_ppo_torch import cli
from burn_ppo_torch.interactive import InteractiveApp, _with_discard, expand_sources, make_handler
from burn_ppo_torch.ppo.rollout import TorchRandomSource

GAUNTLET = Path(__file__).resolve().parent.parent / "gauntlet"
R4 = GAUNTLET / "skull" / "r4"


@pytest.fixture(scope="module")
def app():
    return InteractiveApp([R4], limit_per_run=1, device="cpu")


@pytest.fixture(scope="module")
def server(app):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(app))
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}"
    httpd.shutdown()
    httpd.server_close()


def call(base, path, body=None, sid="testsession"):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        base + path,
        data=data,
        headers={"x-session-id": sid, "content-type": "application/json"},
        method="POST" if body is not None else "GET",
    )
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def call_status(base, path, body=None, sid="testsession"):
    """Like call() but returns (status_code, json) without raising."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        base + path,
        data=data,
        headers={"x-session-id": sid, "content-type": "application/json"},
        method="POST" if body is not None else "GET",
    )
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_index_serves_html(server):
    with urllib.request.urlopen(server + "/") as r:
        html = r.read().decode()
    assert "Skull Assistant" in html


def test_networks_listed(server):
    r = call(server, "/api/networks")
    assert r["networks"] == ["r4"]


def test_new_game_and_state(server):
    r = call(server, "/api/new_game", {"num_players": 3, "ai_seat": 1})
    assert r["ok"]
    state = r["state"]
    assert state["active"]
    assert len(state["players"]) == 3
    assert state["phase"] == "placing"
    assert state["players"][1]["is_ai"]


def test_execute_action_and_undo(server):
    call(server, "/api/new_game", {"num_players": 4, "ai_seat": 0})
    state = call(server, "/api/game_state")
    action = state["valid_actions"][0]["id"]
    r = call(server, "/api/execute_action", {"action": action})
    assert r.get("ok") or r.get("pending_discard")
    r2 = call(server, "/api/undo", {})
    assert r2["ok"]
    state2 = call(server, "/api/game_state")
    assert state2["current_player"] == 0


def test_invalid_action_rejected(server):
    call(server, "/api/new_game", {"num_players": 4, "ai_seat": 0})
    r = call(server, "/api/execute_action", {"action": 32})  # reveal P5: invalid
    assert "error" in r


def test_ai_probs_and_sample(server):
    call(server, "/api/new_game", {"num_players": 4, "ai_seat": 0})
    r = call(server, "/api/ai_probs", {})
    assert len(r["probs"]) >= 2
    total = sum(p["prob"] for p in r["probs"])
    assert 0.5 < total <= 1.001
    r2 = call(server, "/api/ai_sample", {})
    assert r2.get("ok")
    hist = call(server, "/api/history")
    assert len(hist["history"]) >= 1


def test_hide_private_info(server):
    call(server, "/api/new_game", {"num_players": 4, "ai_seat": 2})
    call(server, "/api/set_hide_info", {"hide": True})
    state = call(server, "/api/game_state")
    # non-AI seats hide skull/rose info; AI seat visible
    assert state["players"][0]["has_skull"] is None
    assert state["players"][2]["has_skull"] is not None
    call(server, "/api/set_hide_info", {"hide": False})


def test_sessions_isolated(server):
    call(server, "/api/new_game", {"num_players": 4, "ai_seat": 0}, sid="s1")
    state2 = call(server, "/api/game_state", sid="s2")
    assert not state2["active"]


def test_ai_probs_sum_to_one(server):
    call(server, "/api/new_game", {"num_players": 3, "ai_seat": 0}, sid="p1")
    r = call(server, "/api/ai_probs", {}, sid="p1")
    probs = r["probs"]
    total = sum(p["prob"] for p in probs)
    assert abs(total - 1.0) < 1e-3
    assert all(p["prob"] >= 0 for p in probs)


def test_illegal_action_has_zero_prob_or_absent(server):
    call(server, "/api/new_game", {"num_players": 3, "ai_seat": 0}, sid="p2")
    r = call(server, "/api/ai_probs", {}, sid="p2")
    # placing phase: pass (action 26) is illegal; it must not be suggested
    names = [p["label"] for p in r["probs"] if p["prob"] > 0]
    assert all("Pass" not in n for n in names)


def test_history_endpoint_tracks_actions(server):
    call(server, "/api/new_game", {"num_players": 3, "ai_seat": 1}, sid="p3")
    call(server, "/api/execute_action", {"action": 1}, sid="p3")  # place rose
    r = call(server, "/api/history", sid="p3")
    assert len(r["history"]) == 1
    assert "Rose" in r["history"][0]["action"]
    call(server, "/api/clear_history", {}, sid="p3")
    r = call(server, "/api/history", sid="p3")
    assert r["history"] == []


def test_set_ai_seat_roundtrip(server):
    call(server, "/api/new_game", {"num_players": 4, "ai_seat": 0}, sid="p4")
    call(server, "/api/set_ai_seat", {"seat": 2}, sid="p4")
    r = call(server, "/api/game_state", sid="p4")
    assert r["ai_seat"] == 2


def test_new_game_player_counts(server):
    for n in (2, 5):
        r = call(server, "/api/new_game", {"num_players": n, "ai_seat": 0}, sid=f"pc{n}")
        assert len(r["state"]["players"]) == n


def test_set_ai_seat_validates_range_and_types(server):
    call(server, "/api/new_game", {"num_players": 3, "ai_seat": 0})
    code, r = call_status(server, "/api/set_ai_seat", {"seat": 99})
    assert code == 400 and "seat" in r["error"]
    code, r = call_status(server, "/api/set_ai_seat", {"seat": "abc"})
    assert code == 400
    code, r = call_status(server, "/api/set_ai_seat", {"seat": None})
    assert code == 400
    code, r = call_status(server, "/api/set_ai_seat", {"seat": 2})
    assert code == 200 and r["ok"]


def test_malformed_post_fields_return_400(server):
    call(server, "/api/new_game", {"num_players": 3, "ai_seat": 0})
    code, _ = call_status(server, "/api/execute_action", {"action": "boom"})
    assert code == 400
    code, _ = call_status(server, "/api/select_network", {"index": None})
    assert code == 400


def test_undo_with_pending_discard_cancels_only(server, app):
    """Undo during a pending skull-reveal discard must cancel the prompt
    without popping the previous applied move (the pending reveal never
    pushed to the undo stack)."""
    sid = "undotest"
    call(server, "/api/new_game", {"num_players": 3, "ai_seat": 0}, sid=sid)
    state = call(server, "/api/game_state", sid=sid)
    action = state["valid_actions"][0]["id"]
    call(server, "/api/execute_action", {"action": action}, sid=sid)
    sess = app.sessions[sid]
    depth = len(sess.history)
    assert depth >= 1
    sess.pending_discard = {"action": 0, "bidder": 0}
    r = call(server, "/api/undo", {}, sid=sid)
    assert r["ok"]
    assert app.sessions[sid].pending_discard is None
    assert len(app.sessions[sid].history) == depth  # nothing popped
    # A second undo now pops the real move.
    r = call(server, "/api/undo", {}, sid=sid)
    assert r["ok"]
    assert len(app.sessions[sid].history) == depth - 1


def test_a_game_to_its_end_with_a_discard_keeps_the_terminal_state(server, app):
    """A skull reveal asks for the discard; the chosen coaster goes; a game
    played to its end shows its winner: the last move's position is the
    plain step's terminal state on the same uniform, with its obs and
    mask (the step runs with its reset off); undo steps back from the
    end."""
    sid = "endgame"
    call(server, "/api/new_game", {"num_players": 2, "ai_seat": 0}, sid=sid)
    # P0 skull, P1 rose, P0 bids 2: P0 reveals its own skull.
    for a in (0, 1, 3):
        assert call(server, "/api/execute_action", {"action": a}, sid=sid)["ok"]
    r = call(server, "/api/execute_action", {"action": 27}, sid=sid)
    assert r["pending_discard"] and r["bidder"] == 0
    assert call_status(server, "/api/execute_discard", {"choice": "skull"}, sid=sid)[0] == 200
    state = call(server, "/api/game_state", sid=sid)
    assert not state["players"][0]["has_skull"] and state["players"][0]["roses"] == 3
    r = call(server, "/api/execute_discard", {"choice": "rose"}, sid=sid)
    assert r["error"] == "no pending discard"
    sess = app.sessions[sid]
    moves = 0
    while not state["game_over"]:
        # A rose while one can be placed, else the highest bid, else the
        # first valid action; a skull reveal costs the bidder a rose.
        ids = [a["id"] for a in state["valid_actions"]]
        bids = [a for a in ids if 2 <= a < 26]
        a = 1 if 1 in ids else max(bids) if bids else ids[0]
        before, drawn = sess.pos.state, sess.generator.get_state()
        discard = -1
        r = call(server, "/api/execute_action", {"action": a}, sid=sid)
        if r.get("pending_discard"):
            r = call(server, "/api/execute_discard", {"choice": "rose"}, sid=sid)
            discard = 1
        state = r["state"]
        moves += 1
        assert moves < 100
    assert state["winner"] >= 0 and state["valid_actions"] == []
    assert f"Winner: P{state['winner']}" in state["render"]
    env = sess.env
    u = env.draw_step(TorchRandomSource(torch.Generator().set_state(drawn)), 1)
    terminal, _, done = env.step(_with_discard(before, discard),
                                 torch.tensor([a], dtype=torch.int32), u)
    assert bool(done[0]) and bool(terminal.game_over[0])
    terminal = _with_discard(terminal, -1)
    assert torch.equal(sess.pos.state.ints, terminal.ints)
    assert torch.equal(sess.pos.state.shaping_coef, terminal.shaping_coef)
    assert torch.equal(sess.pos.obs, env.obs(terminal))
    assert torch.equal(sess.pos.mask, env.action_mask(terminal))
    assert not sess.pos.mask.any()
    assert call(server, "/api/undo", {}, sid=sid)["ok"]
    assert not call(server, "/api/game_state", sid=sid)["game_over"]


def test_a_gauntlet_directory_lists_its_checkpoints():
    got = expand_sources([GAUNTLET / "skull", R4])
    assert [p.name for p in got] == ["r4", "r4_best", "r4_flagship", "r4_flagship_best",
                                     "r4_mid", "r4"]
    assert expand_sources([R4]) == [R4]
    app = InteractiveApp([GAUNTLET / "skull"], device="cpu")
    assert sorted(n["name"] for n in app.networks) == ["r4", "r4_best", "r4_flagship",
                                                       "r4_flagship_best", "r4_mid"]


def test_the_command_line_serves_the_assistant_and_refuses_other_games(monkeypatch, capsys):
    served = []

    def serve_forever(self):
        served.append(self.server_address)
        raise KeyboardInterrupt

    monkeypatch.setattr(ThreadingHTTPServer, "serve_forever", serve_forever)
    assert cli.main(["interactive", str(GAUNTLET / "skull"), "-p", "0"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "5 network(s) loaded on cpu" in out and served[0][0] == "127.0.0.1"
    assert cli.main(["interactive", str(GAUNTLET / "connect_four" / "r4")], device="cpu") == 2
    assert "requires skull checkpoints" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The port's app beside the JAX package's
# ---------------------------------------------------------------------------
def _pick(state: dict, k: int) -> int:
    """A fixed rule over the valid actions: the k-th mod their count."""
    ids = [a["id"] for a in state["valid_actions"]]
    return ids[k % len(ids)]


def test_port_and_jax_apps_agree_on_r4_along_a_game(app):
    """Both apps load gauntlet/skull/r4 and play one fixed sequence from a
    new four-player game (a skull reveal with the discard chosen, then a
    fixed rule over the valid actions, 22 moves): ``game_state_json``
    equal at every position, ``_model_probs`` within 2e-6 of JAX's. Every
    discard is a chosen coaster, never the random one, so JAX's session
    key draws nothing that the port would have to replay."""
    import jax
    from burn_ppo_tpu.envs.skull import Skull as JaxSkull
    from burn_ppo_tpu.interactive import InteractiveApp as JaxApp

    apps = (JaxApp([R4], limit_per_run=1), app)
    sessions = [a.session("parity")[1] for a in apps]
    jax_sess, port_sess = sessions
    jax_sess.env = JaxSkull(4)
    jax_sess.state = jax_sess.env.reset(jax.random.PRNGKey(0))
    port_sess.new_game(4)
    for s in sessions:
        s.ai_seat = 1
    discards = moves = 0
    script = [0, 1, 1, 1, 5]  # P0 skull, three roses, P0 bids 4: reveals its own skull
    k = 0
    while True:
        states = [a.game_state_json(s) for a, s in zip(apps, sessions)]
        assert states[0] == states[1], moves
        if states[0]["game_over"] or moves >= 22:
            break
        pj, pp = (np.asarray(a._model_probs(s)) for a, s in zip(apps, sessions))
        np.testing.assert_allclose(pp, pj, rtol=0, atol=2e-6)
        action = script[moves] if moves < len(script) else _pick(states[0], k)
        k += 3
        res = [a.execute_action(s, action) for a, s in zip(apps, sessions)]
        if res[0].get("pending_discard"):
            assert res[1].get("pending_discard") and res[0]["bidder"] == res[1]["bidder"]
            st = states[0]["players"][res[0]["bidder"]]
            choice = "skull" if discards % 2 == 0 and st["has_skull"] else (
                "rose" if st["roses"] else "skull")
            res = [a.execute_discard(s, choice) for a, s in zip(apps, sessions)]
            discards += 1
        assert res[0] == res[1] or (res[0].get("state") == res[1].get("state")), moves
        moves += 1
    assert discards >= 1 and moves >= 20
    assert [h["action"] for h in jax_sess.action_history] == [
        h["action"] for h in port_sess.action_history]
