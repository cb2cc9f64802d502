"""Interactive web UI: a Skull game assistant, on the card.

Counterpart of burn_ppo_tpu/interactive.py (the reference's
``interactive`` subcommand, src/interactive.rs): an embedded single-page
web app backed by a JSON API for assisting a physical Skull game:
per-tab sessions (the ``x-session-id`` header), network selection, the
AI's seat, action probabilities, AI sampling, an undo stack, a
hidden-information toggle, the discard choice when a skull is revealed,
and the action history (interactive.rs:60-127, 402-1256, routes
1342-1356).

Each session's game is one env, a batch of one, on the app's device: a
move runs the env step kernel (K11, ``skull_step_autoreset`` at E = 1)
with the session's own ``torch.Generator`` drawing the lost coaster's
uniform (the JAX key's part) and the kernel's reset off, so that a move
that ends the game leaves its terminal position.
The networks are the port's checkpoint loads on the device; a request's
probabilities are the actor's forward (obs norm through K6) and a masked
softmax there. The text and JSON are read from a host copy of the state.
Python's stdlib ThreadingHTTPServer serves it: every request is a tiny
forward or one env step.
"""

from __future__ import annotations

import dataclasses
import json
import secrets
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from burn_ppo_torch.checkpoint import load_metadata
from burn_ppo_torch.device import resolve_device
from burn_ppo_torch.envs.base import EpisodeAccumulator, env_row
from burn_ppo_torch.envs.skull import A, CARDS, REVEAL_BASE, SKULL_C, Skull, SkullState
from burn_ppo_torch.eval import ActingLogits
from burn_ppo_torch.ops.categorical import apply_action_mask
from burn_ppo_torch.ppo.rollout import TorchRandomSource
from burn_ppo_torch.tournament import discover_contestants, is_checkpoint_dir, is_run_dir


@dataclasses.dataclass
class Position:
    """One game position on the device: the state (a batch of one), its
    obs [1, D] and action mask [1, A] (the step kernel's outputs, or the
    plain functions' for a fresh state)."""

    state: SkullState
    obs: torch.Tensor
    mask: torch.Tensor


class Session:
    def __init__(self, device: torch.device):
        self.device = device
        self.selected_network = 0
        self.env: Optional[Skull] = None
        self.pos: Optional[Position] = None
        self.acc: Optional[EpisodeAccumulator] = None
        self.history: List[Position] = []  # undo stack of positions
        self.pending_discard: Optional[Dict] = None
        self.ai_seat = 0
        self.hide_private_info = False
        self.action_history: List[Dict] = []
        self.last_active = time.time()
        # The JAX key's part: the lost coaster's uniform of every step.
        self.generator = torch.Generator(device=device).manual_seed(secrets.randbits(63))
        self.rng = TorchRandomSource(self.generator)
        # Serializes handler threads touching this session's mutable game
        # state (ThreadingHTTPServer: two tabs sharing a sid would race
        # _apply/undo and lose moves; the reference wraps sessions in a
        # mutex). app.lock guards only the sessions dict.
        self.lock = threading.Lock()

    @property
    def state(self) -> Optional[SkullState]:
        return None if self.pos is None else self.pos.state

    def new_game(self, num_players: int) -> None:
        env = Skull(num_players)
        state = env.reset(env.draw_reset(self.rng, 1))
        self.env = env
        self.pos = Position(state, env.obs(state), env.action_mask(state))
        self.acc = EpisodeAccumulator.zero(1, num_players, self.device)


def _with_discard(state: SkullState, discard: int) -> SkullState:
    return SkullState.of(**{**state.fields(),
                            "forced_discard": torch.full_like(state.forced_discard, discard)})


def _host(state: SkullState) -> Dict[str, Any]:
    """The fields of a batch of one as Python values (one host copy)."""
    return {name: t[0].tolist() for name, t in env_row(state).fields().items()}


def expand_sources(sources: Sequence[str | Path]) -> List[Path]:
    """The sources with a directory of checkpoint directories (a gauntlet,
    such as ``gauntlet/skull``) replaced by its checkpoints, sorted; a
    checkpoint, a run directory or a directory of ``step_*`` checkpoints
    stays as it is."""
    out: List[Path] = []
    for src in map(Path, sources):
        entries = [] if not src.is_dir() or is_checkpoint_dir(src) or is_run_dir(src) else sorted(
            c for c in src.iterdir() if is_checkpoint_dir(c) and not c.name.startswith("step_"))
        out.extend(entries or [src])
    return out


class InteractiveApp:
    def __init__(self, sources: Sequence[str | Path], limit_per_run: int = 1,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        contestants = discover_contestants(expand_sources(sources), limit_per_run=limit_per_run,
                                           device=self.device)
        if not contestants:
            raise ValueError("No checkpoints found")
        self.networks = []
        for c in contestants:
            meta = load_metadata(c.path)
            if meta["env_name"] != "skull":
                continue
            self.networks.append({"name": c.name, "source": c.source, "meta": meta})
        if not self.networks:
            raise ValueError("Interactive mode requires skull checkpoints")
        self.sessions: Dict[str, Session] = {}
        self.lock = threading.Lock()

    # -- session plumbing -------------------------------------------------
    def session(self, session_id: Optional[str]) -> Tuple[str, Session]:
        with self.lock:
            sid = session_id or secrets.token_hex(8)
            if sid not in self.sessions:
                self.sessions[sid] = Session(self.device)
            s = self.sessions[sid]
            s.last_active = time.time()
            # Drop sessions idle > 2h
            if len(self.sessions) > 64:
                cutoff = time.time() - 7200
                for k in [k for k, v in self.sessions.items() if v.last_active < cutoff]:
                    del self.sessions[k]
            return sid, s

    # -- game helpers ------------------------------------------------------
    def _model_probs(self, sess: Session) -> List[float]:
        """The selected network's action probabilities of the current
        position, formed on the device: the actor's forward (obs norm
        first), then a softmax of the masked logits."""
        src = self.networks[sess.selected_network]["source"]
        with torch.no_grad():
            logits = ActingLogits._forward(src, sess.pos.obs)
            probs = torch.softmax(apply_action_mask(logits, sess.pos.mask), dim=-1)[0]
        return [float(p) for p in probs.cpu().numpy()]

    def game_state_json(self, sess: Session) -> Dict:
        if sess.pos is None:
            return {"active": False}
        env = sess.env
        n = env.spec.num_players
        s = _host(sess.state)
        mask = sess.pos.mask[0].cpu().numpy()
        cur = s["current"]
        players = []
        for p in range(n):
            stack_len = s["stack_len"][p]
            revealed = s["revealed"][p]
            show = (not sess.hide_private_info) or p == sess.ai_seat
            cards = []
            for i in range(stack_len):
                card = s["stack"][p * CARDS + i]
                top_rev = i >= stack_len - revealed
                cards.append(("S" if card == SKULL_C else "R") if (show or top_rev) else "?")
            players.append(
                {
                    "seat": p,
                    "alive": bool(s["has_trap"][p] or s["rose_count"][p] > 0),
                    "wins": s["wins"][p],
                    "coasters": int(s["has_trap"][p]) + s["rose_count"][p],
                    "has_skull": bool(s["has_trap"][p]) if show else None,
                    "roses": s["rose_count"][p] if show else None,
                    "stack": cards,
                    "revealed": revealed,
                    "passed": bool(s["passed"][p]),
                    "is_current": p == cur,
                    "is_ai": p == sess.ai_seat,
                }
            )
        actions = [{"id": int(a), "label": env.describe_action(int(a))}
                   for a in np.nonzero(mask)[0]]
        return {
            "active": True,
            "phase": ["placing", "bidding", "revealing"][s["phase"]],
            "current_player": cur,
            "current_bid": s["current_bid"],
            "current_bidder": s["current_bidder"],
            "roses_found": s["roses_found"],
            "game_over": bool(s["game_over"]),
            "winner": s["winner"],
            "players": players,
            "valid_actions": actions,
            "pending_discard": sess.pending_discard is not None,
            "ai_seat": sess.ai_seat,
            "hide_private_info": sess.hide_private_info,
            "can_undo": len(sess.history) > 0,
            "render": env.render(sess.state),
        }

    def execute_action(self, sess: Session, action: int) -> Dict:
        mask = sess.pos.mask[0].cpu().numpy()
        if action < 0 or action >= A or not mask[action]:
            return {"error": f"invalid action {action}"}
        s = _host(sess.state)
        # Detect a skull reveal -> pause for discard choice
        if s["phase"] == 2 and action >= REVEAL_BASE:
            target = action - REVEAL_BASE
            idx = s["stack_len"][target] - 1 - s["revealed"][target]
            if idx >= 0 and s["stack"][target * CARDS + idx] == SKULL_C:
                sess.pending_discard = {"action": action, "bidder": s["current_bidder"]}
                return {
                    "pending_discard": True,
                    "bidder": s["current_bidder"],
                    "message": "Skull revealed! Choose which coaster the "
                    "bidder discards.",
                }
        return self._apply(sess, action, discard=-1)

    def _step(self, sess: Session, state: SkullState, action: int) -> Position:
        """One move through the env step kernel at E = 1, with the reset
        off: a move that ends the game leaves its terminal position."""
        env, rng = sess.env, sess.rng
        a = torch.tensor([action], dtype=torch.int32, device=sess.device)
        with torch.no_grad():
            out = env.step_autoreset(state, sess.acc, a, env.draw_reset(rng, 1),
                                     env.draw_step(rng, 1), reset=False)
        sess.acc = out.acc
        return Position(out.state, out.obs, out.mask)

    def _apply(self, sess: Session, action: int, discard: int) -> Dict:
        env = sess.env
        sess.history.append(sess.pos)
        if len(sess.history) > 200:
            sess.history = sess.history[-200:]
        player = int(env.current_player(sess.state)[0])
        pos = self._step(sess, _with_discard(sess.state, discard), action)
        sess.pos = dataclasses.replace(pos, state=_with_discard(pos.state, -1))
        sess.pending_discard = None
        sess.action_history.append(
            {
                "player": player,
                "action": env.describe_action(action),
                "ts": time.time(),
            }
        )
        return {"ok": True, "state": self.game_state_json(sess)}

    def execute_discard(self, sess: Session, choice: str) -> Dict:
        if sess.pending_discard is None:
            return {"error": "no pending discard"}
        # Reference lose_coaster_specified (skull.rs:327-360) REJECTS a
        # choice the bidder cannot make; validating here keeps the
        # physical-game assistant from recording a discard that never
        # happened (the env would degrade it to the random path).
        bidder = sess.pending_discard["bidder"]
        s = _host(sess.state)
        if choice == "skull" and not s["has_trap"][bidder]:
            return {"error": "bidder no longer has their skull coaster"}
        if choice == "rose" and s["rose_count"][bidder] <= 0:
            return {"error": "bidder has no rose coasters left"}
        discard = {"random": -1, "skull": 0, "rose": 1}.get(choice, -1)
        action = sess.pending_discard["action"]
        return self._apply(sess, action, discard)


# ---------------------------------------------------------------------------
HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>Skull Assistant</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#1c1f26;color:#e8e8e8}
 header{padding:10px 16px;background:#12141a;display:flex;gap:12px;align-items:center;flex-wrap:wrap}
 h1{font-size:18px;margin:0}
 main{display:grid;grid-template-columns:1fr 320px;gap:14px;padding:14px}
 .card{background:#262a33;border-radius:10px;padding:12px}
 button{background:#3b4252;color:#eee;border:0;border-radius:6px;padding:6px 10px;margin:2px;cursor:pointer}
 button:hover{background:#4c566a}
 button.primary{background:#5e81ac}
 .player{border:1px solid #3b4252;border-radius:8px;padding:8px;margin:6px 0}
 .player.current{border-color:#a3be8c}
 .player.ai{background:#2e3440}
 .chip{display:inline-block;border-radius:4px;padding:1px 7px;margin:1px;background:#434c5e}
 .chip.S{background:#bf616a}.chip.R{background:#a3be8c;color:#111}.chip.q{background:#4c566a}
 .bar{height:10px;background:#5e81ac;border-radius:3px}
 .prob{display:flex;align-items:center;gap:8px;font-size:13px;margin:2px 0}
 .prob span.l{width:120px}
 pre{white-space:pre-wrap;font-size:12px;color:#9aa}
 select{background:#3b4252;color:#eee;border:0;padding:4px}
 #msg{color:#ebcb8b}
</style></head><body>
<header>
 <h1>Skull Assistant</h1>
 <select id="network"></select>
 Players: <select id="nplayers"><option>2</option><option>3</option><option selected>4</option><option>5</option><option>6</option></select>
 AI seat: <select id="aiseat"></select>
 <button class="primary" onclick="newGame()">New game</button>
 <button onclick="undo()">Undo</button>
 <label><input type="checkbox" id="hide" onchange="setHide()"> Hide private info</label>
 <span id="msg"></span>
</header>
<main>
 <div class="card" id="board"></div>
 <div>
  <div class="card"><b>AI suggestion</b>
    <div><button onclick="aiProbs()">Show probabilities</button>
    <button class="primary" onclick="aiSample()">AI plays</button></div>
    <div id="probs"></div></div>
  <div class="card"><b>History</b> <button onclick="clearHist()">clear</button><div id="hist"></div></div>
 </div>
</main>
<script>
let SID = localStorage.getItem('sid') || Math.random().toString(16).slice(2);
localStorage.setItem('sid', SID);
async function api(path, body){
  const r = await fetch(path, {method: body?'POST':'GET',
    headers:{'x-session-id':SID,'content-type':'application/json'},
    body: body?JSON.stringify(body):undefined});
  return r.json();
}
async function init(){
  const nets = await api('/api/networks');
  const sel = document.getElementById('network');
  sel.innerHTML = nets.networks.map((n,i)=>`<option value="${i}">${n}</option>`).join('');
  sel.onchange = ()=>api('/api/select_network',{index:+sel.value});
  refreshSeats(); refresh();
}
function refreshSeats(){
  const n = +document.getElementById('nplayers').value;
  document.getElementById('aiseat').innerHTML =
    Array.from({length:n},(_,i)=>`<option value="${i}">P${i}</option>`).join('');
}
document.getElementById('nplayers').onchange = refreshSeats;
async function newGame(){
  const n = +document.getElementById('nplayers').value;
  const seat = +document.getElementById('aiseat').value;
  await api('/api/new_game', {num_players:n, ai_seat:seat});
  refresh();
}
async function refresh(){
  const s = await api('/api/game_state');
  render(s.state || s);
}
function render(s){
  const b = document.getElementById('board');
  if(!s.active){ b.innerHTML = '<i>No game — press New game.</i>'; return; }
  let h = `<b>Phase:</b> ${s.phase} | <b>Current:</b> P${s.current_player}`;
  if(s.current_bid>0) h += ` | <b>Bid:</b> ${s.current_bid} by P${s.current_bidder} (roses found: ${s.roses_found})`;
  if(s.game_over) h += ` | <b style="color:#a3be8c">WINNER: P${s.winner}</b>`;
  h += s.players.map(p=>`
   <div class="player ${p.is_current?'current':''} ${p.is_ai?'ai':''}">
    <b>P${p.seat}${p.is_ai?' (AI)':''}</b> ${p.alive?'':'&#10060;'}
    wins:${p.wins} coasters:${p.coasters}
    ${p.has_skull===null?'':`| skull:${p.has_skull?'yes':'no'} roses:${p.roses}`}
    ${p.passed?'| <i>passed</i>':''}
    <div>stack: ${p.stack.map(c=>`<span class="chip ${c=='?'?'q':c}">${c}</span>`).join('')}
     ${p.revealed?`(revealed ${p.revealed})`:''}</div>
   </div>`).join('');
  if(s.pending_discard){
    h += `<div><b>Skull revealed!</b> Discard:
      <button onclick="discard('random')">Random</button>
      <button onclick="discard('skull')">Skull</button>
      <button onclick="discard('rose')">Rose</button></div>`;
  } else if(!s.game_over){
    h += '<div>' + s.valid_actions.map(a=>
      `<button onclick="act(${a.id})">${a.label}</button>`).join('') + '</div>';
  }
  b.innerHTML = h;
  loadHist();
}
async function act(a){
  const r = await api('/api/execute_action', {action:a});
  document.getElementById('msg').textContent = r.message || r.error || '';
  refresh();
}
async function discard(c){ await api('/api/execute_discard',{choice:c}); refresh(); }
async function undo(){ await api('/api/undo'); refresh(); }
async function setHide(){
  await api('/api/set_hide_info', {hide: document.getElementById('hide').checked});
  refresh();
}
async function aiProbs(){
  const r = await api('/api/ai_probs', {});
  if(r.error){document.getElementById('msg').textContent=r.error;return;}
  document.getElementById('probs').innerHTML = r.probs.map(p=>
   `<div class="prob"><span class="l">${p.label}</span>
     <div class="bar" style="width:${Math.round(p.prob*160)}px"></div>
     ${(p.prob*100).toFixed(1)}%</div>`).join('');
}
async function aiSample(){
  const r = await api('/api/ai_sample', {});
  document.getElementById('msg').textContent = r.message || r.error || '';
  refresh();
}
async function loadHist(){
  const r = await api('/api/history');
  document.getElementById('hist').innerHTML =
    r.history.slice(-25).reverse().map(e=>`<div>P${e.player}: ${e.action}</div>`).join('');
}
async function clearHist(){ await api('/api/clear_history',{}); loadHist(); }
init();
</script></body></html>
"""


def make_handler(app: InteractiveApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("content-type", "application/json")
            self.send_header("content-length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> Dict:
            length = int(self.headers.get("content-length", 0) or 0)
            if length == 0:
                return {}
            try:
                return json.loads(self.rfile.read(length))
            except json.JSONDecodeError:
                return {}

        def do_GET(self):
            sid = self.headers.get("x-session-id")
            if self.path == "/":
                body = HTML.encode()
                self.send_response(200)
                self.send_header("content-type", "text/html; charset=utf-8")
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            _, sess = app.session(sid)
            with sess.lock:
                if self.path == "/api/networks":
                    self._json({"networks": [n["name"] for n in app.networks]})
                elif self.path == "/api/game_state":
                    self._json(app.game_state_json(sess))
                elif self.path == "/api/history":
                    self._json({"history": sess.action_history})
                else:
                    self._json({"error": "not found"}, 404)

        def do_POST(self):
            sid = self.headers.get("x-session-id")
            _, sess = app.session(sid)
            try:
                with sess.lock:
                    self._dispatch_post(sess)
            except (TypeError, ValueError) as e:
                # Malformed JSON field types (int(None), int("abc"), ...)
                # answer 400 instead of killing the connection with a
                # traceback.
                self._json({"error": f"bad request: {e}"}, 400)

        def _dispatch_post(self, sess):
            body = self._body()
            path = self.path
            if path == "/api/select_network":
                idx = int(body.get("index", 0))
                if 0 <= idx < len(app.networks):
                    sess.selected_network = idx
                    self._json({"ok": True})
                else:
                    self._json({"error": "bad network index"}, 400)
            elif path == "/api/new_game":
                try:
                    n = int(body.get("num_players", 4))
                    ai_seat = int(body.get("ai_seat", 0))
                except (TypeError, ValueError):
                    self._json({"error": "num_players/ai_seat must be ints"}, 400)
                    return
                if not 2 <= n <= 6:
                    self._json({"error": "num_players must be in [2, 6]"}, 400)
                    return
                if not 0 <= ai_seat < n:
                    self._json({"error": f"ai_seat must be in [0, {n - 1}]"}, 400)
                    return
                sess.new_game(n)
                sess.history = []
                sess.action_history = []
                sess.pending_discard = None
                sess.ai_seat = ai_seat
                self._json({"ok": True, "state": app.game_state_json(sess)})
            elif path == "/api/execute_action":
                if sess.state is None:
                    self._json({"error": "no active game"}, 400)
                else:
                    self._json(app.execute_action(sess, int(body.get("action", -1))))
            elif path == "/api/execute_discard":
                self._json(app.execute_discard(sess, body.get("choice", "random")))
            elif path == "/api/ai_probs":
                if sess.state is None:
                    self._json({"error": "no active game"}, 400)
                else:
                    probs = app._model_probs(sess)
                    mask = sess.pos.mask[0].cpu().numpy()
                    items = [
                        {
                            "action": int(a),
                            "label": sess.env.describe_action(int(a)),
                            "prob": probs[a],
                        }
                        for a in np.nonzero(mask)[0]
                    ]
                    items.sort(key=lambda x: -x["prob"])
                    self._json({"probs": items[:12]})
            elif path == "/api/ai_sample":
                if sess.state is None:
                    self._json({"error": "no active game"}, 400)
                else:
                    probs = np.asarray(app._model_probs(sess))
                    mask = sess.pos.mask[0].cpu().numpy()
                    probs = probs * mask
                    if probs.sum() <= 0:
                        self._json({"error": "no valid action"}, 400)
                    else:
                        probs = probs / probs.sum()
                        action = int(
                            np.random.default_rng(
                                secrets.randbits(32)
                            ).choice(len(probs), p=probs)
                        )
                        result = app.execute_action(sess, action)
                        result["message"] = (
                            f"AI: {sess.env.describe_action(action)}"
                        )
                        self._json(result)
            elif path == "/api/set_ai_seat":
                seat = int(body.get("seat", 0))
                n_seats = sess.env.n if sess.env is not None else 6
                if not 0 <= seat < n_seats:
                    # Out-of-range seat would hide every hand (show
                    # requires p == ai_seat) and advise a ghost player.
                    self._json(
                        {"error": f"seat must be in [0, {n_seats - 1}]"}, 400
                    )
                else:
                    sess.ai_seat = seat
                    self._json({"ok": True})
            elif path == "/api/set_hide_info":
                sess.hide_private_info = bool(body.get("hide", False))
                self._json({"ok": True})
            elif path == "/api/undo":
                if sess.pending_discard is not None:
                    # A pending reveal never pushed to the undo stack —
                    # undo just cancels the discard prompt. Popping here
                    # would erase the PREVIOUS applied move.
                    sess.pending_discard = None
                    self._json({"ok": True, "message": "discard cancelled"})
                elif sess.history:
                    sess.pos = sess.history.pop()
                    if sess.action_history:
                        sess.action_history.pop()
                    self._json({"ok": True})
                else:
                    self._json({"error": "nothing to undo"}, 400)
            elif path == "/api/clear_history":
                sess.action_history = []
                self._json({"ok": True})
            else:
                self._json({"error": "not found"}, 404)

    return Handler


def run_interactive_cli(args, device: str | torch.device = "cuda") -> int:
    app = InteractiveApp(args.sources, limit_per_run=args.limit_per_run, device=device)
    # Loopback by default, like the reference (interactive.rs:1360): the
    # API has no authentication, so a wide bind must be an explicit
    # --host opt-in.
    host = getattr(args, "host", "127.0.0.1")
    server = ThreadingHTTPServer((host, args.port), make_handler(app))
    print(
        f"Skull assistant: http://{'localhost' if host == '127.0.0.1' else host}"
        f":{args.port} ({len(app.networks)} network(s) loaded on {app.device})"
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\nshutting down")
    finally:
        server.server_close()
    return 0
