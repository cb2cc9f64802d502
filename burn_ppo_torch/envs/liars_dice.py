"""Liar's Dice, four players, as batched tensors, with the fused step kernel K13.

Counterpart of burn_ppo_tpu/envs/liars_dice.py: two dice a player, 49
actions (48 bids, quantity 1-8 x face 1-6, then CALL), wild 1s (a 1
counts as any other face, and a bid of 1s counts only 1s), a call that
costs the loser a die, placements by elimination order with the rewards
(1.0, 0.33, -0.33, -1.0) replacing the survival shaping at game end, a
270-wide player-relative obs and a 120-wide privileged obs for the CTDE
critic (110 exact, zero padded).

The integer state is ONE packed ``[E, 76]`` i32 tensor (``LAYOUT``, then
three zero pad columns) with the fields as views, beside the f32 shaping
coefficient, so the kernel takes two state pointers in and writes two out.

``step`` is the plain PyTorch version: the bid, call and invalid branches
are computed for every env and selected, as ``lax.switch`` under ``vmap``
computes them. The dice are drawn by the caller: ``draw_reset`` gives
[E, 8] uniforms for a fresh game, ``draw_step`` [E, 8] for the reroll
when a call starts a new round, and ``faces`` maps a uniform to
``min(floor(u * 6), 5) + 1``. The JAX env draws ``randint(1, 7)`` from a
key in its state; the tests hand the port ``u = (face - 0.5) / 6`` to
replay it.

``step_autoreset`` is the rollout's env step. For CPU tensors it runs the
plain composition (``envs/base.py autoreset_step`` over ``step``,
``reset``, ``obs``, ``action_mask``, ``privileged_obs`` and
``game_outcome``); for CUDA tensors it launches the hand-written kernel
``csrc/liars_dice_step.cu`` (ROADMAP B12), or raises. Given a sampling
``front`` (``ops/categorical.py TemperatureFront``, eval's step) it steps
with K14's sample of it: the plain sample then the plain step on the CPU,
one launch of the kernel with its sampling front on a card.
"""

from __future__ import annotations

from typing import Optional

import torch

from burn_ppo_torch import kernels
from burn_ppo_torch.envs.base import (
    EnvSpec,
    Environment,
    EpisodeAccumulator,
    EpisodeLog,
    ShapedPackedState,
    StepOutput,
    action_sources,
    arena_size,
    autoreset_step,
    carve_arena,
    env_row,
    first_true_clockwise,
    onehot_eq,
    push_ring_row,
    read_at,
)
from burn_ppo_torch.ops.categorical import front_args

P = 4  # players
DICE = 2  # dice per player
FACES = 6
MAX_DICE = P * DICE  # 8
A = MAX_DICE * FACES + 1  # 49
CALL = A - 1  # 48
HIST = 16
OBS_DIM = 270
PRIV_DIM = 120
PLACEMENT_REWARDS = (1.0, 0.33, -0.33, -1.0)  # f32 constants, as the reference's

# XLA turns a division by a constant into a product with its f32
# reciprocal, and the reference's values are those products: x / 6 and
# x * f32(1/6) differ in the last bit for some x (/2, /4 and /8 are exact).
INV_FACES = 1.0 / FACES
INV_BID_COUNT_OBS = 1.0 / 20.0
INV_BID_COUNT_PRIV = 1.0 / (P * 3)

# The packed integer state: (field, per-env shape), in column order.
LAYOUT = (
    ("dice", (P, DICE)),  # face values 1-6
    ("dice_count", (P,)),
    ("current", ()),
    ("bid_qty", ()),  # 0 = no bid
    ("bid_face", ()),
    ("last_bidder", ()),  # -1 = none
    ("bid_count", ()),
    ("hist", (HIST, 3)),  # (bidder, qty, face) rows, oldest first
    ("hist_len", ()),
    ("placements", (P,)),  # 0 until assigned
    ("num_eliminated", ()),
    ("game_over", ()),  # 0 / 1
    ("step_idx", ()),
)


class LiarsDiceState(ShapedPackedState):
    """E envs: ``ints`` [E, 76] i32 with the fields of ``LAYOUT`` as views,
    ``state.dice`` [E, 4, 2] and so on (``game_over`` as bool), and the
    shaping coefficient (envs/base.py ShapedPackedState)."""

    LAYOUT = LAYOUT
    BOOL_FIELDS = frozenset(("game_over",))
    W = 76  # 73 columns, then 3 zero pad columns: every row starts 16-byte aligned


FIELDS = LiarsDiceState.FIELDS
W = LiarsDiceState.W


def faces(u: torch.Tensor) -> torch.Tensor:
    """[E, 8] uniforms in [0, 1) -> [E, 4, 2] i32 dice, min(floor(6u), 5) + 1."""
    f = torch.clamp(torch.floor(u * FACES), max=FACES - 1).to(torch.int32) + 1
    return f.reshape(u.shape[0], P, DICE)


class LiarsDice(Environment):
    spec = EnvSpec(
        name="liars_dice",
        obs_dim=OBS_DIM,
        num_actions=A,
        num_players=P,
        privileged_obs_dim=PRIV_DIM,
        eval_temp=1.0,
    )
    context_fields = ("shaping_coef",)

    def draw_reset(self, rng, num_envs: int) -> torch.Tensor:
        """The fresh dice: [E, 8] f32 uniforms."""
        return rng.uniform((num_envs, P * DICE), 0.0, 1.0)

    def draw_step(self, rng, num_envs: int) -> torch.Tensor:
        """The reroll of a new round: [E, 8] f32 uniforms, used only where a
        call starts one."""
        return rng.uniform((num_envs, P * DICE), 0.0, 1.0)

    def reset(self, reset_values: torch.Tensor) -> LiarsDiceState:
        E, dev, i32 = reset_values.shape[0], reset_values.device, torch.int32
        fields = {name: torch.zeros((E, *shape), dtype=i32, device=dev)
                  for name, shape in LAYOUT}
        fields.update(dice=faces(reset_values), last_bidder=torch.full((E,), -1, dtype=i32,
                                                                        device=dev))
        fields["dice_count"].fill_(DICE)
        return LiarsDiceState.of(torch.zeros(E, device=dev), **fields)

    # -- step (liars_dice.py:133-257) ----------------------------------------
    def step(self, state: LiarsDiceState, action: torch.Tensor, u: torch.Tensor):
        """Plain PyTorch step. ``u`` [E, 8] f32 in [0, 1) are the reroll's
        dice. Returns (stepped, rewards [E, 4], done)."""
        s = state.fields()
        i32 = torch.int32
        # Out-of-range actions are invalid before any clip: 55 must not
        # become CALL (liars_dice.py:134-140).
        in_range = (action >= 0) & (action < A)
        a = torch.clamp(action, 0, A - 1).to(i32)
        cur = s["current"]
        dc = s["dice_count"]
        is_call = a == CALL
        qty = a // FACES + 1
        face = a % FACES + 1
        no_bid = s["bid_qty"] == 0
        higher = (qty > s["bid_qty"]) | ((qty == s["bid_qty"]) & (face > s["bid_face"]))
        bid_valid = ~is_call & (qty <= dc.sum(1)) & (no_bid | higher)
        call_valid = is_call & ~no_bid
        invalid = s["game_over"] | ~in_range | ~(bid_valid | call_valid)

        # -- bid ---------------------------------------------------------------
        hist, hist_len = push_ring_row(s["hist"], s["hist_len"],
                                       torch.stack([cur, qty, face], 1).to(i32), HIST)
        bid = {**s, "bid_qty": qty, "bid_face": face, "last_bidder": cur,
               "bid_count": s["bid_count"] + 1, "hist": hist, "hist_len": hist_len,
               "current": first_true_clockwise(dc > 0, cur, P)}

        # -- call --------------------------------------------------------------
        call, call_rewards, over = self._call(s, cur, state.shaping_coef, u)

        take_call = is_call & ~invalid
        take_bid = ~is_call & ~invalid
        new = {}
        for name in FIELDS:
            x = s[name]
            for take, branch in ((take_bid, bid), (take_call, call)):
                x = torch.where(take.reshape(-1, *([1] * (x.dim() - 1))), branch[name], x)
            new[name] = x
        new["game_over"] = torch.where(invalid, True, new["game_over"])
        new["step_idx"] = s["step_idx"] + 1
        rewards = torch.where(take_call[:, None], call_rewards, 0.0).to(torch.float32)
        done = invalid | (take_call & over)
        return LiarsDiceState.of(state.shaping_coef, **new), rewards, done

    @staticmethod
    def _call(s: dict, cur, shaping, u):
        """The call branch (liars_dice.py:173-244): (state fields, rewards
        [E, 4], game over). Computed for every env and selected; where the
        last bidder is -1 (a call with no bid, discarded) the seat reads give
        0, as JAX's one-hot reads do."""
        i32 = torch.int32
        dc, bid_face = s["dice_count"], s["bid_face"]
        live = torch.arange(DICE, device=dc.device)[None, None, :] < dc[:, :, None]
        bf = bid_face[:, None, None]
        hit = (s["dice"] == bf) | ((s["dice"] == 1) & (bf != 1))  # wild 1s
        actual = (hit & live).sum((1, 2))
        loser = torch.where(actual < s["bid_qty"], s["last_bidder"], cur).to(i32)
        oh_loser = onehot_eq(loser, P)
        dc = dc - oh_loser.to(i32)
        eliminated = read_at(dc, loser) == 0
        placements = torch.where(eliminated[:, None] & oh_loser, (P - s["num_eliminated"])[:, None],
                                 s["placements"])
        alive = dc > 0
        over = alive.sum(1) <= 1
        winner = torch.argmax(alive.to(i32), dim=1)  # the lowest seat alive
        placements = torch.where(over[:, None] & onehot_eq(winner, P), 1, placements).to(i32)
        table = torch.tensor(PLACEMENT_REWARDS, dtype=torch.float32, device=dc.device)
        final = table[torch.clamp(placements - 1, 0, P - 1).long()]
        # Survival shaping for the players alive, replaced by the placement
        # rewards at game end.
        rewards = torch.where(over[:, None], final, torch.where(alive, shaping[:, None], 0.0))
        nxt = torch.where(read_at(dc, loser) > 0, loser, first_true_clockwise(alive, loser, P))

        # The terminal state keeps the decisive bid and history; a new round
        # rerolls every die and clears the round.
        def keep(x, fresh):
            return torch.where(over.reshape(-1, *([1] * (x.dim() - 1))), x, fresh)

        call = {**s, "dice": keep(s["dice"], faces(u)), "dice_count": dc,
                "current": keep(cur, nxt.to(i32)), "bid_qty": keep(s["bid_qty"], 0),
                "bid_face": keep(bid_face, 0), "last_bidder": keep(s["last_bidder"], -1),
                "bid_count": keep(s["bid_count"], 0), "hist": keep(s["hist"], 0),
                "hist_len": keep(s["hist_len"], 0), "placements": placements,
                "num_eliminated": s["num_eliminated"] + eliminated.to(i32), "game_over": over}
        return call, rewards, over

    # -- observation (liars_dice.py:260-309) ---------------------------------
    def obs(self, state: LiarsDiceState) -> torch.Tensor:
        f32 = torch.float32
        cur = state.current
        E, dev = cur.shape[0], cur.device
        seats = torch.arange(P, device=dev)
        rows = torch.arange(E, device=dev)
        dc = state.dice_count
        own = state.dice[rows, cur.long()]  # [E, 2]
        live = torch.arange(DICE, device=dev)[None, :] < read_at(dc, cur)[:, None]
        face_ids = torch.arange(1, FACES + 1, device=dev)
        own_oh = ((own[:, :, None] == face_ids) & live[:, :, None]).to(f32).reshape(E, -1)
        dc_rel = torch.gather(dc, 1, (seats[None, :] + cur[:, None]).long() % P)
        bid_qty, bid_face, last = state.bid_qty, state.bid_face, state.last_bidder
        has_bid = bid_qty > 0
        bid_idx = (bid_qty - 1) * FACES + (bid_face - 1)
        bid_oh = (torch.arange(MAX_DICE * FACES, device=dev)[None, :] == bid_idx[:, None]) & has_bid[:, None]
        bid_cnt = torch.clamp(state.bid_count.to(f32) * INV_BID_COUNT_OBS, max=1.0)
        last_oh = onehot_eq((last + P - cur) % P, P) & (last >= 0)[:, None]
        hist = state.hist
        valid = (torch.arange(HIST, device=dev)[None, :] < state.hist_len[:, None]).to(f32)
        h_bidder = (hist[:, :, 0] + P - cur[:, None]) % P
        hist_obs = torch.cat([
            (h_bidder[:, :, None] == seats).to(f32) * valid[:, :, None],
            (hist[:, :, 1].to(f32) / MAX_DICE * valid)[:, :, None],
            (hist[:, :, 2, None] == face_ids).to(f32) * valid[:, :, None],
            valid[:, :, None],
        ], 2).reshape(E, -1)
        return torch.cat([
            own_oh, dc_rel.to(f32) / DICE, (dc_rel > 0).to(f32), onehot_eq(cur, P).to(f32),
            bid_oh.to(f32), has_bid.to(f32)[:, None], bid_cnt[:, None], last_oh.to(f32), hist_obs,
        ], 1)

    # -- mask (liars_dice.py:312-324) ----------------------------------------
    def action_mask(self, state: LiarsDiceState) -> torch.Tensor:
        dev = state.ints.device
        dc = state.dice_count
        q = torch.arange(1, MAX_DICE + 1, device=dev)[None, :, None]
        f = torch.arange(1, FACES + 1, device=dev)[None, None, :]
        bq, bf = state.bid_qty[:, None, None], state.bid_face[:, None, None]
        no_bid = state.bid_qty == 0
        higher = (q > bq) | ((q == bq) & (f > bf))
        bids = (q <= dc.sum(1)[:, None, None]) & (no_bid[:, None, None] | higher)
        mask = torch.cat([bids.reshape(-1, MAX_DICE * FACES), ~no_bid[:, None]], 1)
        playable = (read_at(dc, state.current) > 0) & ~state.game_over
        return (mask & playable[:, None]).to(torch.float32)

    def current_player(self, state: LiarsDiceState) -> torch.Tensor:
        return state.current.contiguous()

    def current_player_view(self, state: LiarsDiceState) -> torch.Tensor:
        return state.current

    def game_outcome(self, state: LiarsDiceState) -> torch.Tensor:
        return state.placements.contiguous()

    # -- privileged obs (liars_dice.py:333-382) ------------------------------
    def privileged_obs(self, state: LiarsDiceState) -> torch.Tensor:
        f32 = torch.float32
        cur, bid_qty, last = state.current, state.bid_qty, state.last_bidder
        E, dev = cur.shape[0], cur.device
        has_bid = bid_qty > 0
        src = state.hist_len[:, None] - 1 - torch.arange(HIST, device=dev)[None, :]  # newest first
        valid = (src >= 0).to(f32)
        idx = torch.clamp(src, 0, HIST - 1).long()[:, :, None].expand(E, HIST, 3)
        rows = torch.gather(state.hist, 1, idx)
        hist = torch.stack([rows[:, :, 0].to(f32) / P * valid,
                            rows[:, :, 1].to(f32) / MAX_DICE * valid,
                            rows[:, :, 2].to(f32) * INV_FACES * valid], 2).reshape(E, -1)
        dc = state.dice_count
        live = torch.arange(DICE, device=dev)[None, None, :] < dc[:, :, None]
        dice_oh = ((state.dice[:, :, :, None] == torch.arange(1, FACES + 1, device=dev))
                   & live[:, :, :, None]).to(f32).reshape(E, P, -1)
        per_player = torch.cat([(dc.to(f32) / DICE)[:, :, None], (dc > 0).to(f32)[:, :, None],
                                dice_oh], 2).reshape(E, -1)
        flat = torch.cat([
            (cur.to(f32) / P)[:, None],
            torch.where(has_bid, bid_qty.to(f32) / MAX_DICE, 0.0)[:, None],
            torch.where(has_bid, state.bid_face.to(f32) * INV_FACES, 0.0)[:, None],
            torch.where(last >= 0, last.to(f32) / P, -1.0)[:, None],
            (state.bid_count.to(f32) * INV_BID_COUNT_PRIV)[:, None],
            hist, state.game_over.to(f32)[:, None], per_player,
        ], 1)
        return torch.nn.functional.pad(flat, (0, PRIV_DIM - flat.shape[1]))

    def step_autoreset(self, state, acc, action, reset_values, step_values=None,
                       reset: bool = True, front=None) -> StepOutput:
        return liars_dice_step_autoreset(self, state, acc, action, reset_values, step_values,
                                         reset, front)

    # -- human-facing helpers (liars_dice.py:385-433) -------------------------
    def render(self, state: LiarsDiceState, index: int = 0) -> str:
        s = env_row(state, index)
        dc, dice, cur = s.dice_count[0].tolist(), s.dice[0].tolist(), int(s.current[0])
        lines = ["=== Liar's Dice ===", ""]
        for p in range(P):
            marker = "->" if p == cur else "  "
            status = "OUT" if dc[p] == 0 else f"{dc[p]} dice"
            if p == cur:
                ds = " ".join(f"[{dice[p][i]}]" for i in range(dc[p]))
            elif dc[p] > 0:
                ds = " ".join("[?]" for _ in range(dc[p]))
            else:
                ds = ""
            lines.append(f"{marker} Player {p}: {status}  {ds}")
        lines.append("")
        qty = int(s.bid_qty[0])
        if qty > 0:
            lines.append(f"Current bid: {qty} {int(s.bid_face[0])}s "
                         f"(by Player {int(s.last_bidder[0])})")
        else:
            lines.append("No bid yet - first player to bid")
        if bool(s.game_over[0]):
            winner = next((p for p in range(P) if dc[p] > 0), 0)
            lines.append(f"Game Over: Player {winner} wins!")
        return "\n".join(lines)

    def describe_action(self, action: int) -> str:
        if action == CALL:
            return "Call Liar!"
        return f"Bid: {action // FACES + 1} {action % FACES + 1}s"

    def parse_action(self, text: str) -> int:
        t = text.strip().lower()
        if t in ("call", "liar", "l"):
            return CALL
        parts = t.split()
        if len(parts) >= 2:
            qty = int(parts[0])
            face = int(parts[1].rstrip("s"))
            if 1 <= face <= 6 and 1 <= qty <= 8:
                return (qty - 1) * FACES + (face - 1)
        raise ValueError("Enter 'N Fs' (e.g., '3 4s') or 'call'")


def liars_dice_step_autoreset(
    env: LiarsDice,
    state: LiarsDiceState,
    acc: EpisodeAccumulator,
    action: Optional[torch.Tensor],
    reset_values: torch.Tensor,
    u: torch.Tensor,
    reset: bool = True,
    front=None,
) -> StepOutput:
    """One auto-reset step of every env: plain PyTorch on the CPU, kernel
    K13 on a CUDA device. ``reset_values`` and ``u`` [E, 8] are the fresh
    game's and the reroll's uniforms (``draw_reset``, ``draw_step``);
    ``reset`` False keeps a finished env's terminal state. With ``front``
    (and no ``action``) the actions are K14's sample of it, in
    ``StepOutput.actions``."""
    if kernels.on_cpu(state.ints, reset_values, u, *action_sources(action, front)):
        return autoreset_step(env, state, acc, action, reset_values, u, reset, front)
    return _launch(state, acc, action, reset_values, u, reset, front)


kernels.counted(liars_dice_step_autoreset)

# The kernel's outputs, carved from one i32 and one f32 buffer (envs/base.py
# carve_arena); csrc/liars_dice_step.cu computes the same offsets.
I32_OUT = (("ints", W), ("acc_length", 1), ("log_length", 1), ("outcome", P),
           ("active_players", 1))
F32_OUT = (("shaping_coef", 1), ("acc_reward_sum", P), ("rewards", P), ("done", 1),
           ("log_total_rewards", P), ("obs", OBS_DIM), ("mask", A), ("priv", PRIV_DIM))
# With the sampling front the i32 buffer also holds the sampled actions.
ACTIONS_OUT = (("actions", 1),)


def _launch(state: LiarsDiceState, acc: EpisodeAccumulator, action: Optional[torch.Tensor],
            reset_values: torch.Tensor, u: torch.Tensor, reset: bool = True,
            front=None) -> StepOutput:
    E, dev = state.ints.shape[0], state.ints.device
    kernels.expect(state.ints, "state.ints", torch.int32, (E, W))
    kernels.expect_rows16(state.ints, "state.ints")
    kernels.expect(state.shaping_coef, "state.shaping_coef", torch.float32, (E,))
    kernels.expect(acc.reward_sum, "reward_sum", torch.float32, (E, P))
    kernels.expect(acc.length, "length", torch.int32, (E,))
    if front is None:
        kernels.expect(action, "action", torch.int32, (E,))
    kernels.expect(reset_values, "reset_values", torch.float32, (E, P * DICE))
    kernels.expect(u, "u", torch.float32, (E, P * DICE))
    i_out = I32_OUT if front is None else I32_OUT + ACTIONS_OUT
    i32 = torch.empty(arena_size(E, i_out), dtype=torch.int32, device=dev)
    f32 = torch.empty(arena_size(E, F32_OUT), dtype=torch.float32, device=dev)
    oi, of = carve_arena(i32, E, i_out), carve_arena(f32, E, F32_OUT)
    p = kernels.ptr
    err = kernels.library().liars_dice_step_autoreset(
        p(state.ints), p(state.shaping_coef), p(acc.reward_sum), p(acc.length), p(action),
        p(reset_values), p(u), p(i32), p(f32), E, int(reset),
        *front_args(front, oi.get("actions"), A), kernels.stream(dev))
    kernels.check(err, "liars_dice_step_autoreset")
    liars_dice_step_autoreset.launches += 1
    done = of["done"]
    log = EpisodeLog(completed=done, total_rewards=of["log_total_rewards"],
                     length=oi["log_length"], outcome=oi["outcome"],
                     active_players=oi["active_players"])
    return StepOutput(LiarsDiceState(oi["ints"], of["shaping_coef"]),
                      EpisodeAccumulator(of["acc_reward_sum"], oi["acc_length"]),
                      of["rewards"], done, log, of["obs"], of["mask"], of["priv"],
                      actions=oi.get("actions"))


def walk_actions(mask: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """[E] i32 actions of a random walk that reaches every branch of the
    step. Each row bids one of its lowest legal bids or calls: every fourth
    row is patient (one of the two lowest bids, a call 4% of the time, so
    that histories fill past 16 rows), the others call half the time (so
    that games finish); 1% of the rows take an unmasked action and 0.5%
    one out of [0, 49) (-1, 49 or 55)."""
    E, dev = mask.shape[0], mask.device
    legal = mask.clone()
    legal[legal.sum(1) == 0, 0] = 1.0
    bids = legal[:, :CALL]
    patient = torch.arange(E, device=dev) % 4 == 0
    low = bids * (bids.cumsum(1) <= torch.where(patient, 2, 4)[:, None])
    no_bid = low.sum(1) == 0
    low[no_bid, 0] = 1.0
    x = torch.rand(E, generator=g, device=dev)
    call = (legal[:, CALL] > 0) & ((x < torch.where(patient, 0.04, 0.5)) | no_bid)
    act = torch.where(call, CALL, torch.multinomial(low, 1, generator=g)[:, 0])
    y = torch.rand(E, generator=g, device=dev)
    act = torch.where(y < 0.015, torch.multinomial(1.0 - mask + 1e-6, 1, generator=g)[:, 0], act)
    wild = torch.tensor([-1, A, 55], device=dev)[torch.randint(0, 3, (E,), generator=g, device=dev)]
    return torch.where(y < 0.005, wild, act).to(torch.int32)
