"""Skull (Skull & Roses), 2-6 players, as batched tensors, with the fused step kernel K11.

Counterpart of burn_ppo_tpu/envs/skull.py: 33 actions (place skull, place
rose, bids 1-24, pass, reveal seat 0-5), a 135-wide player-relative obs, a
200-wide privileged obs for the CTDE critic (103 exact, zero padded), the
phase machine placing -> bidding -> revealing, a random lost coaster on a
failed challenge, two won challenges or the last player alive to win, and
placements ranked by winner > wins > coasters > later elimination. Seat
arrays are padded to ``MAXP = 6``; ``num_players`` is fixed per env
instance (``with_num_players``).

The integer state is ONE packed ``[E, 108]`` i32 tensor (``LAYOUT``, the
JAX state's fields in its order, bools as 0 / 1, a zero pad column) with
the fields as views, beside the f32 shaping coefficient, so the kernel
takes two state pointers in and writes one i32 and one f32 buffer out.

``step`` is the plain PyTorch version: every branch of the phase machine
is computed for every env and selected, as ``vmap`` of ``lax.cond``
computes it. The lost coaster is ``choice = min(floor(u * c), c - 1)``
for ``c = max(coasters, 1)`` from a per-env uniform ``u`` that the
rollout draws at every step (``draw_step``); the JAX env draws
``randint(0, c)`` from a key in its state, and the tests feed
``u = (choice + 0.5) / c`` to replay it.

``step_autoreset`` is the rollout's env step. For CPU tensors it runs the
plain composition (``envs/base.py autoreset_step`` over ``step``,
``reset``, ``obs``, ``action_mask``, ``privileged_obs`` and
``game_outcome``); for CUDA tensors it launches the hand-written kernel
``csrc/skull_step.cu`` (ROADMAP B13), or raises. Given a sampling
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
    select_state,
)
from burn_ppo_torch.ops.categorical import front_args

MAXP = 6
CARDS = 4  # per player: 3 roses + 1 skull
ROSES = 3
MAX_BID = MAXP * CARDS  # 24
WINS_TO_WIN = 2

PLACE_SKULL = 0
PLACE_ROSE = 1
BID_BASE = 2
PASS = BID_BASE + MAX_BID  # 26
REVEAL_BASE = PASS + 1  # 27
A = REVEAL_BASE + MAXP  # 33

HIST = 8
OBS_DIM = 135
PRIV_DIM = 200
PRIV_HIST = 10  # bid-history rows of the privileged obs, newest first

ROSE_C, SKULL_C = 1, 2  # stack cells: 0 empty, 1 rose, 2 skull

# XLA turns a division by a constant into a product with its f32
# reciprocal, and the reference's values are those products: x / 24 and
# x * f32(1/24) differ in the last bit for some x.
INV_MAX_BID = 1.0 / MAX_BID
INV_MAXP = 1.0 / MAXP
INV_ROSES = 1.0 / ROSES


# The packed integer state: (field, per-env shape), in the order of the
# JAX ``SkullState`` (bools as 0 / 1), then one padding column so that a
# row is 108 i32 and every row starts on a 16-byte boundary.
LAYOUT = (
    ("has_trap", (MAXP,)),  # bool
    ("rose_count", (MAXP,)),
    ("wins", (MAXP,)),
    ("stack", (MAXP * CARDS,)),  # seat * CARDS + position
    ("skulls_in", (MAXP,)),  # skulls placed this round
    ("roses_in", (MAXP,)),  # roses placed this round
    ("stack_len", (MAXP,)),
    ("passed", (MAXP,)),  # bool
    ("phase", ()),  # 0 placing, 1 bidding, 2 revealing
    ("current", ()),
    ("round_starter", ()),
    ("current_bid", ()),  # 0 = none
    ("current_bidder", ()),  # -1 = none
    ("hist", (HIST, 2)),  # (player, bid; 0 = pass)
    ("hist_len", ()),
    ("revealed", (MAXP,)),
    ("roses_found", ()),
    ("must_reveal_own", ()),  # bool
    ("elim_pos", (MAXP,)),  # -1 = not eliminated
    ("num_eliminated", ()),
    ("game_over", ()),  # bool
    ("winner", ()),  # -1
    ("step_idx", ()),
    ("forced_discard", ()),  # -1 random, 0 skull, 1 rose
)


class SkullState(ShapedPackedState):
    """E envs: ``ints`` [E, 108] i32 with the fields of ``LAYOUT`` as views,
    ``state.stack`` [E, 24], ``state.hist`` [E, 8, 2] and so on, the bools
    of ``BOOL_FIELDS`` as bool, and the shaping coefficient (envs/base.py
    ShapedPackedState)."""

    LAYOUT = LAYOUT
    BOOL_FIELDS = frozenset(("has_trap", "passed", "must_reveal_own", "game_over"))
    W = 108  # one zero pad column: every row starts 16-byte aligned
    # Every field of the JAX ``SkullState`` the port keeps (not its key nor
    # its emitted rewards / done, which the step returns), in the JAX order.
    FIELDS = tuple(name for name, _ in LAYOUT[:-1]) + ("shaping_coef", "forced_discard")


FIELDS = SkullState.FIELDS
W = SkullState.W


def _rep(s: SkullState, **kw) -> SkullState:
    """``s`` with the named fields replaced: their columns written into a
    copy of ``s.ints``."""
    ints = s.ints.clone()
    for name, v in kw.items():
        lo, hi, _ = SkullState.SLICES[name]
        ints[:, lo:hi] = v.reshape(v.shape[0], hi - lo)
    return SkullState(ints, s.shaping_coef)


class Skull(Environment):
    context_fields = ("shaping_coef",)

    def __init__(self, num_players: int = 4):
        if not 2 <= num_players <= MAXP:
            raise ValueError(f"Skull supports 2-{MAXP} players, got {num_players}")
        self.n = num_players
        self.spec = EnvSpec(
            name="skull",
            obs_dim=OBS_DIM,
            num_actions=A,
            num_players=num_players,
            privileged_obs_dim=PRIV_DIM,
            eval_temp=1.0,
            variable_player_count=True,
        )

    def with_num_players(self, n: int) -> "Skull":
        return Skull(n)

    def draw_reset(self, rng, num_envs: int) -> torch.Tensor:
        """The reset is deterministic: [E, 0]."""
        return torch.empty(num_envs, 0, device=rng.device)

    def draw_step(self, rng, num_envs: int) -> torch.Tensor:
        """One uniform per env for the lost coaster: [E] f32 in [0, 1)."""
        return rng.uniform((num_envs,), 0.0, 1.0)

    # -- helpers ----------------------------------------------------------
    def _exists(self, device) -> torch.Tensor:
        return torch.arange(MAXP, device=device) < self.n

    def _alive(self, s: SkullState) -> torch.Tensor:
        return self._exists(s.has_trap.device)[None, :] & (s.has_trap | (s.rose_count > 0))

    @staticmethod
    def _coasters(s: SkullState) -> torch.Tensor:
        return s.has_trap.to(torch.int32) + s.rose_count

    def _next_alive(self, s: SkullState, frm: torch.Tensor) -> torch.Tensor:
        return first_true_clockwise(self._alive(s), frm, self.n)

    def _next_non_passed(self, s: SkullState, frm: torch.Tensor):
        ok = self._alive(s) & ~s.passed
        return ok.any(1), first_true_clockwise(ok, frm, self.n)

    # -- lifecycle ----------------------------------------------------------
    def reset(self, reset_values: torch.Tensor) -> SkullState:
        """A fresh game in every env: one packed row, repeated."""
        E, dev, i32 = reset_values.shape[0], reset_values.device, torch.int32
        exists = self._exists(dev)[None, :]

        def z(*shape, fill=0):
            return torch.full((1, *shape), fill, dtype=i32, device=dev)

        row = SkullState.of(
            torch.zeros(1, device=dev), has_trap=exists, rose_count=torch.where(exists, ROSES, 0),
            wins=z(MAXP), stack=z(MAXP * CARDS), skulls_in=z(MAXP), roses_in=z(MAXP),
            stack_len=z(MAXP), passed=z(MAXP), phase=z(), current=z(), round_starter=z(),
            current_bid=z(), current_bidder=z(fill=-1), hist=z(HIST, 2), hist_len=z(),
            revealed=z(MAXP), roses_found=z(), must_reveal_own=z(), elim_pos=z(MAXP, fill=-1),
            num_eliminated=z(), game_over=z(), winner=z(fill=-1), step_idx=z(),
            forced_discard=z(fill=-1),
        ).ints
        return SkullState(row.expand(E, W).clone(), torch.zeros(E, device=dev))

    # -- placements and rewards (skull.py:200-226) --------------------------
    def game_outcome(self, s: SkullState) -> torch.Tensor:
        """[E, n] competition-ranked placements: winner > wins > coasters >
        later elimination; ties share a place."""
        n = self.n
        idx = torch.arange(n, device=s.wins.device)
        is_winner = (s.winner[:, None] == idx[None, :]).to(torch.int32)
        elim = s.elim_pos[:, :n]
        elim_rank = torch.where(elim >= 0, elim, s.num_eliminated[:, None])
        key = (is_winner * (1 << 24) + s.wins[:, :n] * (1 << 16)
               + self._coasters(s)[:, :n] * (1 << 8) + elim_rank)
        better = (key[:, None, :] > key[:, :, None]).sum(2)
        return (better + 1).to(torch.int32)

    def _final_rewards(self, s: SkullState) -> torch.Tensor:
        n = self.n
        place = self.game_outcome(s)
        ties = (place[:, None, :] == place[:, :, None]).to(torch.float32).sum(2)
        eff = (place.to(torch.float32) - 1.0) + (ties - 1.0) / 2.0
        # 1 - 2 eff / (n - 1) as the reference computes it: one fused
        # multiply-add with the f32 reciprocal of n - 1, a single rounding
        # (exact in f64, then rounded to f32).
        inv = float(torch.tensor(1.0 / (n - 1), dtype=torch.float32))
        return (1.0 - (2.0 * eff).to(torch.float64) * inv).to(torch.float32)

    # -- transitions --------------------------------------------------------
    def _start_new_round(self, s: SkullState, starter: torch.Tensor) -> SkullState:
        cur = torch.where(read_at(self._alive(s), starter), starter, self._next_alive(s, starter))
        zeros6 = torch.zeros_like(s.stack_len)
        zero = torch.zeros_like(s.phase)
        return _rep(
            s, stack=torch.zeros_like(s.stack), skulls_in=zeros6, roses_in=zeros6,
            stack_len=zeros6, passed=torch.zeros_like(s.passed), revealed=zeros6, phase=zero,
            current_bid=zero, current_bidder=torch.full_like(zero, -1),
            hist=torch.zeros_like(s.hist), hist_len=zero, roses_found=zero,
            must_reveal_own=torch.zeros_like(s.must_reveal_own), current=cur.to(torch.int32),
            round_starter=cur.to(torch.int32),
        )

    @staticmethod
    def _push_hist(s: SkullState, player: torch.Tensor, bid: torch.Tensor) -> SkullState:
        entry = torch.stack([player, bid], dim=1).to(torch.int32)
        hist, hist_len = push_ring_row(s.hist, s.hist_len, entry, HIST)
        return _rep(s, hist=hist, hist_len=hist_len)

    @staticmethod
    def _to_revealing(s: SkullState) -> SkullState:
        return _rep(s, phase=torch.full_like(s.phase, 2), current=s.current_bidder,
                    must_reveal_own=torch.ones_like(s.must_reveal_own),
                    roses_found=torch.zeros_like(s.roses_found),
                    revealed=torch.zeros_like(s.revealed))

    def _check_bidding_end(self, s: SkullState) -> SkullState:
        alive_np = self._alive(s) & ~s.passed
        last_idx = torch.argmax(alive_np.to(torch.int32), dim=1).to(torch.int32)  # lowest seat
        found, nxt = self._next_non_passed(s, s.current)
        to_reveal = self._to_revealing(_rep(s, current_bidder=last_idx))
        advance = _rep(s, current=torch.where(found, nxt, s.current))
        return select_state(alive_np.sum(1) == 1, to_reveal, advance)

    def _bid(self, s: SkullState, cur, bid_value, total_cards) -> SkullState:
        """An opening bid from placing or a raise while bidding
        (skull.py:324-346, 352-366): both take the shortcut to revealing
        when the bid equals the cards on the table."""
        s = _rep(s, phase=torch.ones_like(s.phase), current_bid=bid_value, current_bidder=cur)
        s = self._push_hist(s, cur, bid_value)
        found, nxt = self._next_non_passed(s, cur)
        next_or_end = select_state(found, _rep(s, current=nxt), self._check_bidding_end(s))
        return select_state(bid_value == total_cards, self._to_revealing(s), next_or_end)

    def step(self, state: SkullState, action: torch.Tensor, u: torch.Tensor):
        """Plain PyTorch step (skull.py:280-526). ``u`` [E] f32 in [0, 1)
        picks the lost coaster. Returns (stepped, rewards [E, n], done)."""
        dev = state.phase.device
        i32 = torch.int32
        mask = self.action_mask(state)
        in_range = (action >= 0) & (action < A)
        valid = in_range & (torch.gather(mask, 1, torch.clamp(action, 0, A - 1).long()[:, None])[:, 0] > 0)
        action = torch.clamp(action, 0, A - 1).to(i32)
        s = state
        cur = s.current
        total_cards = s.stack_len.sum(1, dtype=i32)
        bid_value = torch.clamp(action - BID_BASE + 1, 1, MAX_BID).to(i32)
        bid = self._bid(s, cur, bid_value, total_cards)

        # -- placing --------------------------------------------------------
        card = torch.where(action == PLACE_SKULL, SKULL_C, ROSE_C).to(i32)
        oh_cur = onehot_eq(cur, MAXP)
        len_cur = read_at(s.stack_len, cur)
        cell = torch.arange(MAXP * CARDS, device=dev)[None, :] == (cur * CARDS + len_cur)[:, None]
        is_skull_card = (card == SKULL_C)[:, None]
        placed = _rep(
            s, stack=torch.where(cell, card[:, None], s.stack),
            stack_len=s.stack_len + oh_cur.to(i32),
            skulls_in=s.skulls_in + (oh_cur & is_skull_card).to(i32),
            roses_in=s.roses_in + (oh_cur & ~is_skull_card).to(i32),
        )
        placed = _rep(placed, current=self._next_alive(placed, cur))
        placing = select_state(action < BID_BASE, placed, bid)

        # -- bidding --------------------------------------------------------
        passing = _rep(s, passed=s.passed | oh_cur)
        passing = self._check_bidding_end(self._push_hist(passing, cur, torch.zeros_like(cur)))
        bidding = select_state(action == PASS, passing, bid)

        # -- revealing ------------------------------------------------------
        revealing, rev_rewards, rev_done = self._reveal(s, action, u)

        phase = torch.clamp(s.phase, 0, 2)  # lax.switch clamps its index
        new = select_state(phase == 0, placing, select_state(phase == 1, bidding, revealing))
        rewards = torch.where((phase == 2)[:, None], rev_rewards, 0.0)
        done = (phase == 2) & rev_done
        # A finished game or an unmasked action: the input state, ended,
        # with zero rewards (skull.py:516-525).
        bad = state.game_over | ~valid
        new = select_state(bad, _rep(state, game_over=torch.ones_like(state.game_over)), new)
        rewards = torch.where(bad[:, None], 0.0, rewards).to(torch.float32)
        done = done | bad
        return _rep(new, step_idx=state.step_idx + 1), rewards, done

    def _reveal(self, s: SkullState, action, u):
        n = self.n
        dev = s.phase.device
        i32 = torch.int32
        bidder = s.current_bidder
        target = torch.clamp(action - REVEAL_BASE, 0, MAXP - 1).to(i32)
        oh_t, oh_b = onehot_eq(target, MAXP), onehot_eq(bidder, MAXP)
        card_idx = read_at(s.stack_len, target) - 1 - read_at(s.revealed, target)
        flat_idx = target * CARDS + torch.clamp(card_idx, 0, CARDS - 1)
        card = read_at(s.stack, flat_idx)
        is_skull = card == SKULL_C
        s = _rep(s, revealed=s.revealed + oh_t.to(i32),
                 roses_found=s.roses_found + (~is_skull).to(i32))
        own_done = (target == bidder) & (read_at(s.stack_len, bidder) - read_at(s.revealed, bidder) <= 0)
        s = _rep(s, must_reveal_own=s.must_reveal_own & ~own_done)
        rsc = s.shaping_coef
        seats_n = torch.arange(n, device=dev)[None, :] == bidder[:, None]
        true_e = torch.ones_like(s.game_over)

        # Skull: the bidder loses a random coaster (skull.py:402-474).
        coasters = read_at(self._coasters(s), bidder)
        trap_b = read_at(s.has_trap, bidder)
        roses_b = read_at(s.rose_count, bidder)
        c = torch.clamp(coasters, min=1)
        choice = torch.minimum(torch.floor(u * c.to(torch.float32)).to(i32), c - 1)
        lose_skull = trap_b & (choice == 0)
        fd = s.forced_discard
        lose_skull = torch.where(fd == 0, trap_b,
                                 torch.where(fd == 1, trap_b & (roses_b == 0), lose_skull))
        has_trap = torch.where(oh_b, s.has_trap & ~lose_skull[:, None], s.has_trap)
        rose_count = s.rose_count + torch.where(
            oh_b, torch.where(lose_skull | (coasters == 0), 0, -1)[:, None], 0).to(i32)
        sk = _rep(s, has_trap=has_trap, rose_count=rose_count)
        newly = (read_at(self._coasters(sk), bidder) == 0) & (read_at(sk.elim_pos, bidder) < 0)
        sk = _rep(sk, elim_pos=torch.where(newly[:, None] & oh_b, sk.num_eliminated[:, None],
                                           sk.elim_pos),
                  num_eliminated=sk.num_eliminated + newly.to(i32))
        alive = self._alive(sk)
        alive_cnt = alive.sum(1)
        first_alive = torch.argmax(alive.to(i32), dim=1).to(i32)
        sk_end = _rep(sk, game_over=true_e,
                      winner=torch.where(alive_cnt >= 1, first_alive, -1).to(i32))
        starter = torch.where(read_at(alive, bidder), bidder,
                              torch.where(read_at(alive, target), target,
                                          self._next_alive(sk, target))).to(i32)
        sk_next = self._start_new_round(sk, starter)
        sk_over = alive_cnt <= 1
        skull_state = select_state(sk_over, sk_end, sk_next)
        lost = torch.where(seats_n, torch.where(rsc > 0, -rsc / CARDS, 0.0)[:, None], 0.0)
        skull_rewards = torch.where(sk_over[:, None], self._final_rewards(sk_end), lost)

        # Rose: a win when the bid is met (skull.py:476-508).
        success = s.roses_found >= s.current_bid
        ro = _rep(s, wins=s.wins + oh_b.to(i32))
        won = (read_at(ro.wins, bidder) >= WINS_TO_WIN) | (self._alive(ro).sum(1) == 1)
        ro_end = _rep(ro, game_over=true_e, winner=bidder)
        ro_state = select_state(won, ro_end, self._start_new_round(ro, bidder))
        gained = torch.where(seats_n, torch.where(rsc > 0, rsc, 0.0)[:, None], 0.0)
        ro_rewards = torch.where(won[:, None], self._final_rewards(ro_end), gained)
        rose_state = select_state(success, ro_state, s)
        rose_rewards = torch.where(success[:, None], ro_rewards, 0.0)

        state = select_state(is_skull, skull_state, rose_state)
        rewards = torch.where(is_skull[:, None], skull_rewards, rose_rewards)
        done = torch.where(is_skull, sk_over, success & won)
        return state, rewards, done

    # -- observation (skull.py:529-616) -------------------------------------
    def obs(self, s: SkullState) -> torch.Tensor:
        n = self.n
        dev = s.phase.device
        f32 = torch.float32
        E = s.phase.shape[0]
        cur = s.current
        rel = torch.arange(MAXP, device=dev)
        absmap = (rel[None, :] + cur[:, None]) % n  # [E, 6]
        valid_rel = (rel < n).to(f32)[None, :]

        def rel_gather(arr):
            return torch.gather(arr, 1, absmap) * valid_rel

        trap_hand = read_at(s.has_trap, cur) & (read_at(s.skulls_in, cur) == 0)
        roses_hand = torch.clamp(read_at(s.rose_count, cur) - read_at(s.roses_in, cur), 0, ROSES)
        own_hand = torch.cat([trap_hand.to(f32)[:, None],
                              (torch.arange(ROSES, device=dev)[None, :] < roses_hand[:, None]).to(f32)], 1)
        seat_cells = s.stack.reshape(E, MAXP, CARDS)
        stack_cur = torch.gather(seat_cells, 1, cur.long()[:, None, None].expand(E, 1, CARDS))[:, 0]
        own_stack = ((stack_cur == SKULL_C)
                     & (torch.arange(CARDS, device=dev)[None, :] < read_at(s.stack_len, cur)[:, None])).to(f32)
        coasters = self._coasters(s).to(f32)
        alive = self._alive(s).to(f32)
        bidder_rel = (s.current_bidder + n - cur) % n
        bidder_oh = onehot_eq(bidder_rel, MAXP) & (s.current_bidder >= 0)[:, None]
        hvalid = (torch.arange(HIST, device=dev)[None, :] < s.hist_len[:, None]).to(f32)  # [E, 8]
        h_rel = (s.hist[:, :, 0] + n - cur[:, None]) % n
        h_bid = s.hist[:, :, 1]
        hist_obs = torch.cat([
            (torch.arange(MAXP, device=dev)[None, None, :] == h_rel[:, :, None]).to(f32) * hvalid[:, :, None],
            (h_bid.to(f32) * INV_MAX_BID * hvalid)[:, :, None],
            ((h_bid == 0).to(f32) * hvalid)[:, :, None],
        ], 2).reshape(E, -1)
        return torch.cat([
            own_hand, own_stack,
            rel_gather(s.stack_len.to(f32) / CARDS), rel_gather(coasters / CARDS), rel_gather(alive),
            valid_rel.expand(E, MAXP), onehot_eq(cur, MAXP).to(f32), onehot_eq(s.phase, 3).to(f32),
            (s.current_bid.to(f32) * INV_MAX_BID)[:, None], bidder_oh.to(f32),
            rel_gather(s.passed.to(f32)), rel_gather(s.wins.to(f32) / WINS_TO_WIN),
            rel_gather(s.revealed.to(f32) / CARDS),
            onehot_eq(torch.full_like(cur, n - 2), MAXP - 1).to(f32), hist_obs,
        ], 1)

    # -- mask (skull.py:619-678) --------------------------------------------
    def action_mask(self, s: SkullState) -> torch.Tensor:
        n = self.n
        dev = s.phase.device
        cur = s.current
        total_cards = s.stack_len.sum(1)
        bids = torch.arange(1, MAX_BID + 1, device=dev)[None, :]
        placing, bidding, revealing = s.phase == 0, s.phase == 1, s.phase == 2
        trap_hand = read_at(s.has_trap, cur) & (read_at(s.skulls_in, cur) == 0)
        roses_hand = read_at(s.rose_count, cur) - read_at(s.roses_in, cur)
        m_skull = placing & trap_hand
        m_rose = placing & (roses_hand > 0)
        can_open = placing & (read_at(s.stack_len, cur) > 0)
        min_bid = torch.clamp(s.current_bid + 1, min=1)
        m_bids = ((can_open | bidding)[:, None] & (bids >= min_bid[:, None])
                  & (bids <= total_cards[:, None]))
        alive_np = self._alive(s) & ~s.passed
        m_pass = bidding & ~read_at(s.passed, cur) & (alive_np.sum(1) > 1)
        unrevealed = s.stack_len - s.revealed
        bidder = s.current_bidder
        is_bidder = revealing & (cur == bidder)
        own_unrevealed = torch.where(bidder >= 0, read_at(unrevealed, bidder), 0)
        must_own = s.must_reveal_own & (own_unrevealed > 0)
        seat = torch.arange(MAXP, device=dev)[None, :]
        m_reveal = is_bidder[:, None] & torch.where(
            must_own[:, None], seat == bidder[:, None], (unrevealed > 0) & (seat < n))
        m_reveal = m_reveal & (unrevealed > 0)
        mask = torch.cat([m_skull[:, None], m_rose[:, None], m_bids, m_pass[:, None], m_reveal], 1)
        return (mask & ~s.game_over[:, None]).to(torch.float32)

    def current_player(self, s: SkullState) -> torch.Tensor:
        return s.current.contiguous()

    def current_player_view(self, s: SkullState) -> torch.Tensor:
        return s.current

    # -- privileged obs (skull.py:690-746) ----------------------------------
    def privileged_obs(self, s: SkullState) -> torch.Tensor:
        n = self.n
        dev = s.phase.device
        f32 = torch.float32
        E = s.phase.shape[0]
        bid_on = s.current_bid > 0
        src = s.hist_len[:, None] - 1 - torch.arange(PRIV_HIST, device=dev)[None, :]  # [E, 10]
        hvalid = (src >= 0).to(f32)
        rows = torch.gather(s.hist, 1, torch.clamp(src, 0, HIST - 1).long()[:, :, None].expand(E, PRIV_HIST, 2))
        hist = torch.stack([rows[:, :, 0].to(f32) * INV_MAXP * hvalid,
                            rows[:, :, 1].to(f32) * INV_MAX_BID * hvalid,
                            (rows[:, :, 1] == 0).to(f32) * hvalid], 2).reshape(E, -1)
        per_player = torch.stack([
            self._exists(dev)[None, :].expand(E, MAXP).to(f32), s.wins.to(f32) / WINS_TO_WIN,
            self._alive(s).to(f32), s.has_trap.to(f32), s.rose_count.to(f32) * INV_ROSES,
            s.stack_len.to(f32) / CARDS, s.skulls_in.to(f32) / CARDS, s.roses_in.to(f32) / CARDS,
            s.passed.to(f32), s.revealed.to(f32) / CARDS,
        ], 2).reshape(E, -1)
        flat = torch.cat([
            onehot_eq(s.phase, 3).to(f32), (s.current.to(f32) * INV_MAXP)[:, None],
            (s.round_starter.to(f32) * INV_MAXP)[:, None],
            torch.where(bid_on, s.current_bid.to(f32) * INV_MAX_BID, 0.0)[:, None],
            torch.where(bid_on & (s.current_bidder >= 0), s.current_bidder.to(f32) * INV_MAXP, -1.0)[:, None],
            hist, s.game_over.to(f32)[:, None],
            onehot_eq(torch.full_like(s.current, n - 2), MAXP - 1).to(f32), per_player,
        ], 1)
        return torch.nn.functional.pad(flat, (0, PRIV_DIM - flat.shape[1]))

    def step_autoreset(self, state, acc, action, reset_values, step_values=None,
                       reset: bool = True, front=None) -> StepOutput:
        """``reset`` False keeps a finished env's terminal state (K11's
        flag): the last move of one game, as the assistant shows it."""
        return skull_step_autoreset(self, state, acc, action, reset_values, step_values, reset,
                                    front)

    # -- human-facing helpers (skull.py:749-814) -----------------------------
    def render(self, state: SkullState, index: int = 0) -> str:
        s = env_row(state, index)
        cur = int(s.current[0])
        phase = ["Placing", "Bidding", "Revealing"][int(s.phase[0])]
        lines = [f"=== Skull ({self.n} players) ===", f"Phase: {phase} | Current Player: P{cur}"]
        if int(s.current_bidder[0]) >= 0:
            lines.append(f"Current Bid: {int(s.current_bid[0])} by P{int(s.current_bidder[0])}")
        lines.append("")
        coasters, alive = self._coasters(s)[0].tolist(), self._alive(s)[0].tolist()
        wins, passed = s.wins[0].tolist(), s.passed[0].tolist()
        revealed, stack_len = s.revealed[0].tolist(), s.stack_len[0].tolist()
        for p in range(self.n):
            curm = ">" if p == cur else " "
            am = " " if alive[p] else "X"
            lines.append(f"{curm}{am} P{p}: {wins[p]}W {coasters[p]}C | "
                         f"Stack: {revealed[p]}/{stack_len[p]} revealed"
                         f"{' (passed)' if passed[p] else ''}")
            if p == cur and stack_len[p] > 0:
                cards = s.stack[0].reshape(MAXP, CARDS)[p][:stack_len[p]].tolist()
                lines.append(f"   Stack contents: [{''.join('S' if c == SKULL_C else 'R' for c in cards)}]")
        if bool(s.game_over[0]) and int(s.winner[0]) >= 0:
            lines.append(f"\nGame Over! Winner: P{int(s.winner[0])}")
        return "\n".join(lines)

    def describe_action(self, action: int) -> str:
        if action == PLACE_SKULL:
            return "Place Skull"
        if action == PLACE_ROSE:
            return "Place Rose"
        if BID_BASE <= action < PASS:
            return f"Bid {action - BID_BASE + 1}"
        if action == PASS:
            return "Pass"
        if REVEAL_BASE <= action < A:
            return f"Reveal P{action - REVEAL_BASE}"
        return f"Unknown action {action}"

    def parse_action(self, text: str) -> int:
        t = text.strip().lower()
        if t in ("skull", "s", "place skull"):
            return PLACE_SKULL
        if t in ("rose", "r", "place rose"):
            return PLACE_ROSE
        if t in ("pass", "p"):
            return PASS
        if t.startswith("bid "):
            t = t[4:].strip()
        if t.isdigit() and 1 <= int(t) <= MAX_BID:
            return BID_BASE + int(t) - 1
        if t.startswith("reveal "):
            rest = t[7:].strip()
            if rest.startswith("p") and rest[1:].isdigit():
                p = int(rest[1:])
                if p < MAXP:
                    return REVEAL_BASE + p
        raise ValueError(f"Unknown action: {text}")


def skull_step_autoreset(
    env: Skull,
    state: SkullState,
    acc: EpisodeAccumulator,
    action: Optional[torch.Tensor],
    reset_values: torch.Tensor,
    u: torch.Tensor,
    reset: bool = True,
    front=None,
) -> StepOutput:
    """One auto-reset step of every env: plain PyTorch on the CPU, kernel
    K11 on a CUDA device. ``u`` [E] are the step's uniforms (``draw_step``);
    ``reset`` False keeps a finished env's terminal state. With ``front``
    (and no ``action``) the actions are K14's sample of it, in
    ``StepOutput.actions``."""
    if kernels.on_cpu(state.ints, reset_values, u, *action_sources(action, front)):
        return autoreset_step(env, state, acc, action, reset_values, u, reset, front)
    return _launch(env, state, acc, action, u, reset, front)


kernels.counted(skull_step_autoreset)


def _outputs(n: int) -> tuple:
    """The kernel's outputs for n players, carved from one i32 and one f32
    buffer (envs/base.py carve_arena); csrc/skull_step.cu computes the same
    offsets."""
    return ((("ints", W), ("acc_length", 1), ("log_length", 1), ("outcome", n),
             ("active_players", 1)),
            (("shaping_coef", 1), ("acc_reward_sum", n), ("rewards", n), ("done", 1),
             ("log_total_rewards", n), ("obs", OBS_DIM), ("mask", A), ("priv", PRIV_DIM)))


def _launch(env: Skull, state: SkullState, acc: EpisodeAccumulator, action: Optional[torch.Tensor],
            u: torch.Tensor, reset: bool = True, front=None) -> StepOutput:
    E, n, dev = state.ints.shape[0], env.n, state.ints.device
    kernels.expect(state.ints, "state.ints", torch.int32, (E, W))
    kernels.expect_rows16(state.ints, "state.ints")
    kernels.expect(state.shaping_coef, "state.shaping_coef", torch.float32, (E,))
    kernels.expect(acc.reward_sum, "reward_sum", torch.float32, (E, n))
    kernels.expect(acc.length, "length", torch.int32, (E,))
    if front is None:
        kernels.expect(action, "action", torch.int32, (E,))
    kernels.expect(u, "u", torch.float32, (E,))
    i32_out, f32_out = _outputs(n)
    if front is not None:
        i32_out += (("actions", 1),)  # the sampled actions
    i32 = torch.empty(arena_size(E, i32_out), dtype=torch.int32, device=dev)
    f32 = torch.empty(arena_size(E, f32_out), dtype=torch.float32, device=dev)
    oi, of = carve_arena(i32, E, i32_out), carve_arena(f32, E, f32_out)
    p = kernels.ptr
    err = kernels.library().skull_step_autoreset(
        p(state.ints), p(state.shaping_coef), p(acc.reward_sum), p(acc.length), p(action), p(u),
        p(i32), p(f32), E, n, int(reset), *front_args(front, oi.get("actions"), A),
        kernels.stream(dev))
    kernels.check(err, "skull_step_autoreset")
    skull_step_autoreset.launches += 1
    done = of["done"]
    log = EpisodeLog(completed=done, total_rewards=of["log_total_rewards"],
                     length=oi["log_length"], outcome=oi["outcome"],
                     active_players=oi["active_players"])
    return StepOutput(SkullState(oi["ints"], of["shaping_coef"]),
                      EpisodeAccumulator(of["acc_reward_sum"], oi["acc_length"]),
                      of["rewards"], done, log, of["obs"], of["mask"], of["priv"],
                      actions=oi.get("actions"))


def walk_actions(mask: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """[E] i32 actions of a random walk that reaches every branch of the
    step: half the rows the highest legal action (so that rounds reach
    their challenge and games end), the rest a random legal one; 1% an
    unmasked action, 0.5% one out of [0, 33)."""
    E, dev = mask.shape[0], mask.device
    legal = mask.clone()
    legal[legal.sum(1) == 0, 0] = 1.0
    pick = torch.multinomial(legal, 1, generator=g)[:, 0]
    top = torch.argmax(legal * torch.arange(1, A + 1, device=dev), dim=1)
    x = torch.rand(E, generator=g, device=dev)
    act = torch.where(x < 0.5, top, pick)
    bad = torch.multinomial(1.0 - mask + 1e-6, 1, generator=g)[:, 0]
    act = torch.where(x < 0.015, bad, act)
    wild = torch.tensor([-1, A, 40], device=dev)[torch.randint(0, 3, (E,), generator=g, device=dev)]
    return torch.where(x < 0.005, wild, act).to(torch.int32)
