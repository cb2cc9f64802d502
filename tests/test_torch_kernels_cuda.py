"""The CUDA kernels K1-K16 against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere. The test suite's conftest
imports JAX; where JAX is not installed, run them without it:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from burn_ppo_torch.envs.base import EpisodeAccumulator, autoreset_step
from burn_ppo_torch.envs.cartpole import CartPole, CartPoleState, cartpole_step_autoreset
from burn_ppo_torch.envs.connect_four import (
    ConnectFour,
    ConnectFourState,
    connect_four_step_autoreset,
)
from burn_ppo_torch.ops.categorical import (
    TINY,
    apply_action_mask,
    masked_sample,
    masked_sample_plain,
    sample_with_temperature,
    sample_with_temperature_plain,
)
from burn_ppo_torch.ops.gae import (
    compute_gae,
    compute_gae_multiplayer,
    compute_gae_multiplayer_plain,
    compute_gae_plain,
)
from burn_ppo_torch.envs.base import EpisodeLog
from burn_ppo_torch.ppo.episode_stats import summarize_episode_logs, summarize_episode_logs_plain
from burn_ppo_torch.envs.liars_dice import LiarsDice, LiarsDiceState, liars_dice_step_autoreset
from burn_ppo_torch.envs.liars_dice import walk_actions as liars_dice_walk
from burn_ppo_torch.envs.skull import Skull, SkullState, skull_step_autoreset, walk_actions
from burn_ppo_torch.ppo.entropy import AdaptiveEntropyState, adaptive_entropy_record
from burn_ppo_torch.ppo.normalization import (
    ObsNormState,
    PopArtState,
    ReturnNormState,
    popart_denormalize,
    popart_denormalize_plain,
    popart_update_rescale,
    popart_update_rescale_plain,
    obs_norm_apply,
    obs_norm_apply_plain,
    obs_norm_update,
    obs_norm_update_plain,
    return_norm_finalize,
    return_norm_finalize_f64,
    return_norm_finalize_f64_plain,
    return_norm_roll,
    return_norm_roll_plain,
    return_norm_scratch,
)
from burn_ppo_torch.ppo.pool_rollout import (
    OPPONENT_TILINGS,
    OpponentStack,
    opponent_actor_forward,
    opponent_actor_forward_plain,
)
from burn_ppo_torch.ppo.update import (
    ADAM_B1,
    ADAM_B2,
    ADAM_BIAS_LEN,
    LossBook,
    PPOUpdateConfig,
    adam_bias_table,
    clip_adam,
    clip_adam_plain,
    clip_adam_scratch,
    ppo_loss,
    ppo_loss_forward,
    ppo_loss_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from burn_ppo_torch.device import resolve_device

    return resolve_device("cuda")


def cartpole_inputs(dev, E, seed):
    """States on both sides of the failure thresholds and the 500-step cap."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g, device=dev)  # noqa: E731
    state = CartPoleState.of(
        (u(E) - 0.5) * 4.9, (u(E) - 0.5) * 4, (u(E) - 0.5) * 0.43, (u(E) - 0.5) * 4,
        torch.randint(0, 500, (E,), generator=g, device=dev, dtype=torch.int32))
    acc = EpisodeAccumulator(u(E, 1) * 100, torch.randint(0, 499, (E,), generator=g, device=dev,
                                                          dtype=torch.int32))
    action = torch.randint(0, 2, (E,), generator=g, device=dev, dtype=torch.int32)
    reset = (u(E, 4) - 0.5) * 0.1
    returns = torch.randn(E, 1, generator=g, device=dev) * 3
    return state, acc, action, reset, returns


def assert_cartpole_steps_close(k, p, rolled):
    """Physics and obs to 1e-5 (sinf/cosf and fma contraction against the
    CPU's), every other output equal, dtypes and shapes too."""
    for a, b in ((k.state.phys, p.state.phys), (k.obs, p.obs)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    pairs = [(k.state.step_idx, p.state.step_idx), (k.rewards, p.rewards), (k.done, p.done),
             (k.acc.reward_sum, p.acc.reward_sum), (k.acc.length, p.acc.length),
             (k.log.total_rewards, p.log.total_rewards), (k.log.length, p.log.length),
             (k.log.outcome, p.log.outcome), (k.log.active_players, p.log.active_players),
             (k.mask, p.mask)]
    if rolled:
        pairs += [(k.returns, p.returns), (k.samples, p.samples)]
    else:
        assert k.returns is None and k.samples is None
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("rolled", [False, True])
@pytest.mark.parametrize("E", [1, 255, 4096, 4097])
def test_cartpole_kernel_matches_plain(dev, E, rolled):
    """K1, with and without the return normaliser's roll folded in, against
    the plain step (then return_norm_roll_plain on slot 0): one launch."""
    env = CartPole()
    state, acc, action, reset, returns = cartpole_inputs(dev, E, E)
    roll = (returns, 0.99) if rolled else None
    before = (cartpole_step_autoreset.launches, return_norm_roll.launches)
    k = env.step_autoreset(state, acc, action, reset, None, roll)
    torch.cuda.synchronize()
    assert (cartpole_step_autoreset.launches, return_norm_roll.launches) == (
        before[0] + 1, before[1])
    p = autoreset_step(env, state, acc, action, reset)
    if rolled:
        ret, samples = return_norm_roll_plain(returns, p.rewards[:, 0],
                                              torch.zeros(E, dtype=torch.int32, device=dev),
                                              p.done, 0.99)
        p = p._replace(returns=ret, samples=samples)
    assert_cartpole_steps_close(k, p, rolled)


def test_cartpole_kernel_replays_from_a_cuda_graph(dev):
    """K1 with the roll captured into a CUDA graph: a replay equal bit for
    bit to the eager call, and no launch counted."""
    env = CartPole()
    E = 4096
    state, acc, action, reset, returns = cartpole_inputs(dev, E, 7)
    eager = env.step_autoreset(state, acc, action, reset, None, (returns, 0.99))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        env.step_autoreset(state, acc, action, reset, None, (returns, 0.99))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = env.step_autoreset(state, acc, action, reset, None, (returns, 0.99))
    before = cartpole_step_autoreset.launches
    graph.replay()
    torch.cuda.synchronize()
    assert cartpole_step_autoreset.launches == before
    for a, b in zip(captured, eager):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert torch.equal(captured.state.phys, eager.state.phys)
    assert torch.equal(captured.log.total_rewards, eager.log.total_rewards)


def test_cartpole_kernel_refuses_misaligned_rows(dev):
    env = CartPole()
    E = 64
    state, acc, action, reset, _ = cartpole_inputs(dev, E, 3)
    shifted = torch.zeros(E * 4 + 1, device=dev)[1:].view(E, 4)
    with pytest.raises(ValueError, match="16-byte"):
        env.step_autoreset(CartPoleState(shifted, state.step_idx), acc, action, reset)
    with pytest.raises(ValueError, match="16-byte"):
        env.step_autoreset(state, acc, action, shifted)


@pytest.mark.parametrize("E,A,masked", [(4096, 2, False), (4096, 2, True), (300, 7, True),
                                        (64, 64, True)])
def test_sample_kernel_matches_plain(dev, E, A, masked):
    g = torch.Generator(device=dev).manual_seed(A)
    logits = torch.randn(E, A, generator=g, device=dev) * 2
    mask = None
    if masked:
        mask = (torch.rand(E, A, generator=g, device=dev) < 0.6).float()
        mask[:, 0] = 1.0
    u = torch.rand(E, A, generator=g, device=dev).clamp_min(TINY)
    before = masked_sample.launches
    a_k, lp_k = masked_sample(logits, mask, u)
    torch.cuda.synchronize()
    assert masked_sample.launches == before + 1
    a_p, lp_p = masked_sample_plain(logits, mask, u)
    assert torch.equal(a_k, a_p)
    torch.testing.assert_close(lp_k, lp_p, rtol=0, atol=1e-5)


def test_sample_kernel_refuses_too_many_actions(dev):
    x = torch.zeros(4, 65, device=dev)
    with pytest.raises(ValueError, match="at most 64"):
        masked_sample(x, None, x + 0.5)


def sample_case(g, dev, rows, A, masked, offset=0):
    """Logits, mask (or None) and uniforms of ``rows`` rows; with an
    ``offset``, views that start ``offset`` rows into larger tensors, as
    the opponents' rows [L:] of a step's mask do."""
    logits = torch.randn(rows + offset, A, generator=g, device=dev)[offset:] * 2
    mask = None
    if masked:
        mask = (torch.rand(rows + offset, A, generator=g, device=dev) < 0.6).float()[offset:]
        mask[:, (torch.arange(rows, device=dev) % A)] = 1.0
    u = torch.rand(rows + offset, A, generator=g, device=dev).clamp_min(TINY)[offset:]
    return logits, mask, u


def assert_sample_close(dev, logits, mask, u):
    """Actions equal where the plain version decides them (top two noisy
    values more than 1e-5 apart), log pi(a) within 1e-5."""
    a_k, lp_k = masked_sample(logits, mask, u)
    a_p, lp_p = masked_sample_plain(logits, mask, u)
    torch.cuda.synchronize()
    noisy = apply_action_mask(logits, mask) - torch.log(-torch.log(u))
    if logits.shape[1] > 1:
        top2 = torch.topk(noisy, 2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 1e-5
    else:
        decided = torch.ones_like(a_p, dtype=torch.bool)
    assert torch.equal(a_k[decided], a_p[decided])
    torch.testing.assert_close(lp_k, lp_p, rtol=0, atol=1e-5)
    return a_k, a_p


@pytest.mark.parametrize("rows,A,offset", [(1024, 49, 3072), (1229, 33, 2867), (1, 33, 0),
                                           (257, 49, 1), (300, 1, 0), (300, 8, 3), (300, 9, 1),
                                           (300, 64, 2), (4096, 49, 0), (4096, 33, 0),
                                           (4096, 7, 0), (257, 2, 1), (33, 8, 0)])
@pytest.mark.parametrize("masked", [True, False])
def test_sample_kernel_at_the_opponent_and_edge_shapes(dev, rows, A, offset, masked):
    """The opponents' [1024, 49] and [1229, 33] (views at rows 3072 and
    2867: the latter does not start 16-byte aligned), one row, a ragged
    last warp, and A = 1, 2, 7, 8, 9 and 64 on both sides of the 2 / 16
    lanes split."""
    g = torch.Generator(device=dev).manual_seed(rows * 100 + A)
    before = masked_sample.launches
    assert_sample_close(dev, *sample_case(g, dev, rows, A, masked, offset))
    assert masked_sample.launches == before + 1


@pytest.mark.parametrize("A,lo,hi", [(49, 13, 18), (49, 15, 16), (49, 1, 48), (33, 5, 20),
                                     (33, 31, 32), (64, 9, 56), (17, 3, 16), (7, 1, 2), (7, 3, 6),
                                     (8, 5, 6)])
def test_sample_kernel_takes_the_first_of_exact_ties_across_lanes(dev, A, lo, hi):
    """Two entries with the same noisy value, held by different lanes, the
    lower index in the higher lane (lane = index mod 16 for A > 8, mod 2
    for A <= 8): the lower index wins, as jnp.argmax's first maximum does.
    The other entries sit at -30, below any noisy value of the pair (the
    Gumbel noise of a u in [tiny, 1) lies in [-4.5, 16.7])."""
    g = torch.Generator(device=dev).manual_seed(A + lo)
    rows = 257
    logits = torch.full((rows, A), -30.0, device=dev)
    logits[:, lo] = logits[:, hi] = 5.0
    u = torch.rand(rows, A, generator=g, device=dev).clamp_min(TINY)
    u[:, hi] = u[:, lo]
    for mask in (None, torch.ones(rows, A, device=dev)):
        a_k, lp_k = masked_sample(logits, mask, u)
        a_p, lp_p = masked_sample_plain(logits, mask, u)
        assert bool((a_k == lo).all()) and torch.equal(a_k, a_p)
        torch.testing.assert_close(lp_k, lp_p, rtol=0, atol=1e-5)


@pytest.mark.parametrize("A", [2, 7, 33, 49])
def test_sample_kernel_with_all_masked_rows_and_without_a_mask(dev, A):
    """Rows with every action masked (the additive -1e9 keeps them finite,
    so they sample as their logits would) beside legal rows; and no mask
    at all (CartPole's call)."""
    g = torch.Generator(device=dev).manual_seed(A)
    logits, mask, u = sample_case(g, dev, 1229, A, True)
    mask[::3] = 0.0
    assert_sample_close(dev, logits, mask, u)
    assert_sample_close(dev, logits, None, u)


@pytest.mark.parametrize("T,E", [(1, 3), (128, 4096), (7, 1000)])
def test_gae_kernel_matches_plain(dev, T, E):
    g = torch.Generator(device=dev).manual_seed(T)
    r = torch.randn(T, E, generator=g, device=dev)
    v = torch.randn(T, E, generator=g, device=dev)
    d = (torch.rand(T, E, generator=g, device=dev) < 0.05).float()
    last = torch.randn(E, generator=g, device=dev)
    before = compute_gae.launches
    adv_k, ret_k = compute_gae(r, v, d, last, 0.99, 0.95)
    torch.cuda.synchronize()
    assert compute_gae.launches == before + 1
    adv_p, ret_p = compute_gae_plain(r, v, d, last, 0.99, 0.95)
    torch.testing.assert_close(adv_k, adv_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(ret_k, ret_p, rtol=0, atol=1e-5)


@pytest.mark.parametrize("T,E", [(128, 4096), (128, 32), (100, 4097), (64, 100), (129, 4096)])
def test_gae_kernel_at_the_chip_shapes_gives_the_same_bits_twice(dev, T, E):
    """The bench shape, configs/cartpole.toml's one block, and ragged
    shapes: a partial chunk, a partial block, the 4-byte copy path (E %
    4 != 0) and a third chunk."""
    g = torch.Generator(device=dev).manual_seed(T + E)
    r = torch.randn(T, E, generator=g, device=dev)
    v = torch.randn(T, E, generator=g, device=dev)
    d = (torch.rand(T, E, generator=g, device=dev) < 0.02).float()
    last = torch.randn(E, generator=g, device=dev)
    adv_k, ret_k = compute_gae(r, v, d, last, 0.99, 0.95)
    adv_2, ret_2 = compute_gae(r, v, d, last, 0.99, 0.95)
    torch.cuda.synchronize()
    assert torch.equal(adv_k, adv_2) and torch.equal(ret_k, ret_2)
    adv_p, ret_p = compute_gae_plain(r, v, d, last, 0.99, 0.95)
    torch.testing.assert_close(adv_k, adv_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(ret_k, ret_p, rtol=0, atol=1e-5)


def test_gae_kernel_takes_views_that_are_not_16_byte_aligned(dev):
    """Rows of a wider buffer, offset by one float: the 4-byte path."""
    g = torch.Generator(device=dev).manual_seed(5)
    T, E = 70, 256
    buf = torch.randn(3, T, E + 1, generator=g, device=dev)
    r, v = buf[0, :, 1:].contiguous(), buf[1, :, 1:].contiguous()
    flat = torch.zeros(T * E + 1, device=dev)
    d = flat[1:].view(T, E)
    d.copy_((torch.rand(T, E, generator=g, device=dev) < 0.05).float())
    last = torch.randn(E, generator=g, device=dev)
    adv_k, ret_k = compute_gae(r, v, d, last, 0.99, 0.95)
    adv_p, ret_p = compute_gae_plain(r, v, d, last, 0.99, 0.95)
    torch.testing.assert_close(adv_k, adv_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(ret_k, ret_p, rtol=0, atol=1e-5)


def test_wrappers_check_arguments(dev):
    with pytest.raises(TypeError):
        compute_gae(torch.zeros(2, 3, device=dev, dtype=torch.float64),
                    torch.zeros(2, 3, device=dev), torch.zeros(2, 3, device=dev),
                    torch.zeros(3, device=dev), 0.99, 0.95)
    with pytest.raises(ValueError, match="contiguous"):
        z = torch.zeros(3, 2, device=dev)
        compute_gae(z.T, z.T, z.T, torch.zeros(3, device=dev), 0.99, 0.95)


def assert_steps_equal(k, p):
    """Every output of two auto-reset steps equal, bit for bit, dtypes too
    (the packed state whole, and its shaping coefficient where it has one)."""
    pairs = [(k.state.ints, p.state.ints)]
    if hasattr(p.state, "shaping_coef"):
        pairs.append((k.state.shaping_coef, p.state.shaping_coef))
    pairs += [(getattr(k.log, f), getattr(p.log, f))
              for f in ("completed", "total_rewards", "length", "outcome", "active_players")]
    pairs += [(k.acc.reward_sum, p.acc.reward_sum), (k.acc.length, p.acc.length),
              (k.rewards, p.rewards), (k.done, p.done), (k.obs, p.obs), (k.mask, p.mask)]
    if p.priv is not None:
        pairs.append((k.priv, p.priv))
    for a, b in pairs:
        assert a.dtype == b.dtype and torch.equal(a, b)
    pad = type(p.state).PAD_COL
    assert not k.state.ints[:, pad:].any()  # the pad columns read zero


@pytest.mark.parametrize("E", [1, 3, 5, 257, 4096])
def test_connect_four_kernel_matches_plain_exactly(dev, E):
    """Random play for 60 steps: mostly legal moves, some full columns and
    out-of-range actions, some states already done; every output equal.
    E = 1, 3, 5 and 257 end on a block with fewer envs than a full one."""
    g = torch.Generator(device=dev).manual_seed(E)
    env = ConnectFour()
    empty = torch.empty(E, 0, device=dev)
    state, acc = env.reset(empty), EpisodeAccumulator.zero(E, 2, dev)
    seen_done = 0
    for t in range(60):
        legal = env.action_mask(state)
        action = torch.multinomial(legal, 1, generator=g)[:, 0]
        wild = torch.randint(-2, 9, (E,), generator=g, device=dev)
        action = torch.where(torch.rand(E, generator=g, device=dev) < 0.1, wild, action)
        action = action.to(torch.int32)
        if t % 9 == 4:
            done = torch.rand(E, generator=g, device=dev) < 0.1
            winner = torch.where(done, torch.randint(-1, 3, (E,), generator=g, device=dev,
                                                     dtype=torch.int32), state.winner)
            state = ConnectFourState.of(**{**state.fields(), "done": done, "winner": winner})
        before = connect_four_step_autoreset.launches
        k = env.step_autoreset(state, acc, action, empty)
        torch.cuda.synchronize()
        assert connect_four_step_autoreset.launches == before + 1
        p = autoreset_step(env, state, acc, action, empty)
        assert_steps_equal(k, p)
        seen_done += int(p.done.sum())
        state, acc = p.state, p.acc
    assert seen_done > 0


def connect_four_branch_rows(dev):
    """(board, current, winner, done, action) rows for the branches a random
    playout rarely reaches: a win that fills the board, a full-board draw,
    out-of-range actions -2, 7 and 9, a full column, and a done input with
    its winner carried."""
    win_fill = [[1, 2, 1, 2, 1, 2, 0],
                [1, 2, 1, 2, 1, 2, 1],
                [2, 1, 2, 1, 2, 1, 1],
                [2, 1, 2, 1, 2, 1, 1],
                [1, 2, 1, 2, 1, 2, 2],
                [1, 2, 1, 2, 1, 2, 2]]
    draw = [row[:] for row in win_fill]
    for r, v in ((1, 2), (2, 1), (3, 2)):
        draw[r][6] = v
    col3 = [[0, 0, 0, 1 + (5 - r) % 2, 0, 0, 0] for r in range(6)]
    mid = [[0] * 7 for _ in range(4)] + [[0, 0, 2, 2, 0, 0, 0], [1, 1, 1, 2, 0, 0, 0]]
    rows = [(win_fill, 0, -1, False, 6), (draw, 0, -1, False, 6),
            (mid, 0, -1, False, -2), (mid, 0, -1, False, 7), (mid, 0, -1, False, 9),
            (col3, 0, -1, False, 3), (mid, 1, 1, True, 4), (mid, 0, 2, True, 4),
            (mid, 0, -1, False, 4)]
    board = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
    i32 = lambda i: torch.tensor([r[i] for r in rows], dtype=torch.int32, device=dev)  # noqa: E731
    state = ConnectFourState.of(board=board, current=i32(1), winner=i32(2),
                                done=torch.tensor([r[3] for r in rows], device=dev),
                                step_idx=torch.arange(len(rows), dtype=torch.int32, device=dev))
    return state, i32(4)


def test_connect_four_kernel_takes_every_branch_exactly(dev):
    """The branch rows, each alone and all together, against the plain
    step: the mover wins the move that fills the board ([1, 2]), the
    full board without a four draws ([1, 1]), invalid moves end with
    [0, 0], and a done input carries its winner (1: [2, 1]; 2 on a board
    that is not full: [0, 0])."""
    state, action = connect_four_branch_rows(dev)
    E = action.shape[0]
    env = ConnectFour()
    g = torch.Generator(device=dev).manual_seed(5)
    acc = EpisodeAccumulator(torch.randint(-2, 3, (E, 2), generator=g, device=dev).float(),
                             torch.arange(E, dtype=torch.int32, device=dev))
    empty = torch.empty(E, 0, device=dev)
    k = env.step_autoreset(state, acc, action, empty)
    p = autoreset_step(env, state, acc, action, empty)
    torch.cuda.synchronize()
    assert_steps_equal(k, p)
    assert k.log.outcome.tolist() == [[1, 2], [1, 1], [0, 0], [0, 0], [0, 0], [0, 0], [2, 1],
                                      [0, 0], [0, 0]]
    assert k.rewards[0].tolist() == [1.0, -1.0] and not k.rewards[1:].any()
    assert k.done.tolist() == [1.0] * 8 + [0.0]
    for i in range(E):
        one = ConnectFourState(state.ints[i:i + 1].clone())
        sub = EpisodeAccumulator(acc.reward_sum[i:i + 1].clone(), acc.length[i:i + 1].clone())
        k1 = env.step_autoreset(one, sub, action[i:i + 1].clone(), empty[:1])
        assert_steps_equal(k1, autoreset_step(env, one, sub, action[i:i + 1], empty[:1]))


def test_sample_kernel_matches_plain_with_connect_four_masks(dev):
    """A = 7 with 0-6 masked columns per row."""
    g = torch.Generator(device=dev).manual_seed(7)
    E, A = 4096, 7
    logits = torch.randn(E, A, generator=g, device=dev) * 2
    n_masked = torch.randint(0, A, (E, 1), generator=g, device=dev)
    mask = (torch.rand(E, A, generator=g, device=dev).argsort(1).argsort(1) >= n_masked).float()
    u = torch.rand(E, A, generator=g, device=dev).clamp_min(TINY)
    a_k, lp_k = masked_sample(logits, mask, u)
    a_p, lp_p = masked_sample_plain(logits, mask, u)
    assert torch.equal(a_k, a_p)
    assert bool(torch.all(torch.gather(mask, 1, a_k.long()[:, None]) == 1.0))
    torch.testing.assert_close(lp_k, lp_p, rtol=0, atol=1e-5)


@pytest.mark.parametrize("T,E,P", [(64, 4096, 2), (64, 4096, 4), (5, 33, 3), (16, 100, 8),
                                   (3, 10, 1)])
def test_gae_multiplayer_kernel_matches_plain(dev, T, E, P):
    g = torch.Generator(device=dev).manual_seed(T * P)
    done = (torch.rand(T, E, generator=g, device=dev) < 0.05).float()
    acting = torch.empty(T, E, dtype=torch.int32, device=dev)
    cur = torch.randint(0, P, (E,), generator=g, device=dev, dtype=torch.int32)
    for t in range(T):
        acting[t] = cur
        restart = torch.randint(0, P, (E,), generator=g, device=dev, dtype=torch.int32)
        cur = torch.where(done[t] > 0, restart, (cur + 1) % P)
    rewards = torch.randn(T, E, P, generator=g, device=dev)
    rewards *= torch.rand(T, E, P, generator=g, device=dev) < 0.3
    values = torch.randn(T, E, generator=g, device=dev)
    last_vpp = torch.randn(E, P, generator=g, device=dev)
    before = compute_gae_multiplayer.launches
    adv_k, ret_k = compute_gae_multiplayer(rewards, values, done, acting, last_vpp, 0.99, 0.95)
    torch.cuda.synchronize()
    assert compute_gae_multiplayer.launches == before + 1
    adv_p, ret_p = compute_gae_multiplayer_plain(rewards, values, done, acting, last_vpp,
                                                 0.99, 0.95)
    torch.testing.assert_close(adv_k, adv_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(ret_k, ret_p, rtol=0, atol=1e-5)


@pytest.mark.parametrize("P", range(1, 9))
@pytest.mark.parametrize("T", [1, 37])
@pytest.mark.parametrize("E", [1, 33, 100, 4097])
def test_gae_multiplayer_kernel_at_the_ragged_edges(dev, E, T, P):
    """K5 where its staged copies fall back or run short: E not a multiple
    of the block's 32 envs or of 4 (4-byte copies), T = 1 and T not a
    multiple of the 16-step chunk, every P, and acting indices -1 and P
    (no seat) on some steps."""
    g = torch.Generator(device=dev).manual_seed(1000 * P + T + E)
    done = (torch.rand(T, E, generator=g, device=dev) < 0.1).float()
    acting = torch.randint(0, P, (T, E), generator=g, device=dev, dtype=torch.int32)
    off = torch.rand(T, E, generator=g, device=dev)
    acting = torch.where(off < 0.05, -1, torch.where(off < 0.1, P, acting)).to(torch.int32)
    rewards = torch.randn(T, E, P, generator=g, device=dev)
    rewards *= torch.rand(T, E, P, generator=g, device=dev) < 0.3
    values = torch.randn(T, E, generator=g, device=dev)
    last_vpp = torch.randn(E, P, generator=g, device=dev)
    adv_k, ret_k = compute_gae_multiplayer(rewards, values, done, acting, last_vpp, 0.99, 0.95)
    adv_p, ret_p = compute_gae_multiplayer_plain(rewards, values, done, acting, last_vpp,
                                                 0.99, 0.95)
    torch.testing.assert_close(adv_k, adv_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(ret_k, ret_p, rtol=0, atol=1e-5)


def test_gae_multiplayer_kernel_refuses_more_than_eight_players(dev):
    z = torch.zeros(2, 3, device=dev)
    with pytest.raises(ValueError, match="1..8 players"):
        compute_gae_multiplayer(torch.zeros(2, 3, 9, device=dev), z, z,
                                torch.zeros(2, 3, dtype=torch.int32, device=dev),
                                torch.zeros(3, 9, device=dev), 0.99, 0.95)


def _obs01(g, dev, n, D):
    rate = torch.rand(D, generator=g, device=dev)
    rate[0] = 0.0  # a constant column
    return (torch.rand(n, D, generator=g, device=dev) < rate).float()


@pytest.mark.parametrize("count", [0.0, 1.0, None])
@pytest.mark.parametrize("shape", [(4096, 86), (3, 5, 86)])
def test_obs_norm_apply_kernel_matches_plain(dev, count, shape):
    g = torch.Generator(device=dev).manual_seed(len(shape))
    D = shape[-1]
    obs = torch.randn(*shape, generator=g, device=dev) * 3
    if count is None:
        state = obs_norm_update_plain(ObsNormState.create(D, dev), _obs01(g, dev, 5000, D))
    else:
        state = ObsNormState(mean=torch.rand(D, generator=g, device=dev),
                             m2=torch.rand(D, generator=g, device=dev),
                             count=torch.tensor(count, device=dev))
    before = obs_norm_apply.launches
    k = obs_norm_apply(state, obs)
    torch.cuda.synchronize()
    assert obs_norm_apply.launches == before + 1
    p = obs_norm_apply_plain(state, obs)
    torch.testing.assert_close(k, p, rtol=0, atol=1e-6)
    if count is not None:
        assert torch.equal(k, obs)


def parent_apply(state, obs, clip=10.0):
    """The one-thread-per-element K6 apply that the float4 kernel replaced,
    element by element: identity while count < 2, else
    clip((x - mean) / max(sqrt(m2 / max(count, 1)), 1e-8)) with IEEE
    division and sqrt; a NaN passes."""
    c = state.count
    std = torch.clamp(torch.sqrt(state.m2 / torch.clamp(c, min=1.0)), min=1e-8)
    z = (obs - state.mean) / std
    z = torch.where(z < -clip, -clip, torch.where(z > clip, clip, z))
    return torch.where(c < 2.0, obs, z)


def assert_bits_equal(a, b):
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


@pytest.mark.parametrize("count", [0.0, 1.0, None])
@pytest.mark.parametrize("rows,D,offset", [(4096, 4, 0), (4096, 86, 0), (4096, 270, 0),
                                          (333, 5, 0), (7, 3, 1), (1023, 86, 2), (257, 270, 3),
                                          (5, 1, 1), (2, 2, 0), (1, 3, 2)])
def test_obs_norm_apply_kernel_is_the_parents_bit_for_bit(dev, count, rows, D, offset):
    """At D = 4, 86 and 270, at rows x D not a multiple of 4, on views that
    start 4, 8 or 12 bytes past a 16-byte boundary, with a NaN entry and
    entries past the clip: the parent kernel's formula bit for bit, and
    the plain version to 1e-6."""
    g = torch.Generator(device=dev).manual_seed(rows * D + offset)
    buf = torch.randn(rows * D + offset, generator=g, device=dev) * 3
    obs = buf[offset:].view(rows, D)
    assert obs.data_ptr() % 16 == 4 * offset
    obs[rows // 2, D - 1] = float("nan")
    obs[0, 0] = 1e4
    if count is None:
        state = obs_norm_update_plain(ObsNormState.create(D, dev), _obs01(g, dev, 5000, D))
    else:
        state = ObsNormState(mean=torch.rand(D, generator=g, device=dev),
                             m2=torch.rand(D, generator=g, device=dev),
                             count=torch.tensor(count, device=dev))
    k = obs_norm_apply(state, obs)
    torch.cuda.synchronize()
    assert k.data_ptr() % 16 == 0
    assert_bits_equal(k, parent_apply(state, obs))
    p = obs_norm_apply_plain(state, obs)
    assert torch.equal(torch.isnan(k), torch.isnan(p))
    torch.testing.assert_close(k.nan_to_num(0.0), p.nan_to_num(0.0), rtol=0, atol=1e-6)


def test_obs_norm_apply_kernel_replays_from_a_cuda_graph(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    D = 270
    state = obs_norm_update_plain(ObsNormState.create(D, dev), _obs01(g, dev, 5000, D))
    obs = torch.randn(4096, D, generator=g, device=dev)
    eager = obs_norm_apply(state, obs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        obs_norm_apply(state, obs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = obs_norm_apply(state, obs)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.parametrize("N,D", [(262144, 86), (524288, 5), (7, 3), (1, 4)])
def test_obs_norm_update_kernel_matches_plain(dev, N, D):
    """Into an empty and into a filled state: mean to 1e-6 absolute, m2 to
    1e-5 relative, count exact."""
    g = torch.Generator(device=dev).manual_seed(N)
    make = ((lambda: _obs01(g, dev, N, D)) if D == 86
            else (lambda: torch.randn(N, D, generator=g, device=dev) * 2 + 0.5))
    state = ObsNormState.create(D, dev)
    for _ in range(2):
        x = make()
        before = obs_norm_update.launches
        k = obs_norm_update(ObsNormState(state.mean.clone(), state.m2.clone(),
                                         state.count.clone()), x)
        torch.cuda.synchronize()
        assert obs_norm_update.launches == before + 1
        p = obs_norm_update_plain(ObsNormState(state.mean.clone(), state.m2.clone(),
                                               state.count.clone()), x)
        torch.testing.assert_close(k.mean, p.mean, rtol=0, atol=1e-6)
        assert bool(torch.all((k.m2 - p.m2).abs() <= 1e-5 * p.m2.abs()))
        assert torch.equal(k.count, p.count)
        state = p


def make_opponents(g, dev, K, act, D=86, H=512, A=7, depth=2):
    """K random actor towers (orthogonal-like scale) and obs normalisers:
    slot 0 at count 0 (identity), slot 1 at count 1, the rest merged."""
    sizes = [D] + [H] * depth + [A]
    weights = [torch.randn(K, i, o, generator=g, device=dev) / i ** 0.5
               for i, o in zip(sizes, sizes[1:])]
    biases = [torch.randn(K, o, generator=g, device=dev) * 0.1 for o in sizes[1:]]
    count = torch.full((K,), 5000.0, device=dev)
    count[0] = 0.0
    if K > 1:
        count[1] = 1.0
    norm = ObsNormState(mean=torch.rand(K, D, generator=g, device=dev),
                        m2=torch.rand(K, D, generator=g, device=dev) * 1000.0, count=count)
    return OpponentStack(weights=weights, biases=biases, activation=act, norm=norm)


@pytest.mark.parametrize("K,act,Ep", [(8, "relu", 1024), (8, "tanh", 1024), (3, "tanh", 37),
                                      (3, "relu", 1500)])
def test_opponent_actor_kernel_matches_plain(dev, K, act, Ep):
    g = torch.Generator(device=dev).manual_seed(K * Ep)
    stack = make_opponents(g, dev, K, act)
    obs = (torch.rand(Ep, 86, generator=g, device=dev) < 0.3).float()
    slot = torch.randint(0, K, (Ep,), generator=g, device=dev, dtype=torch.int32)
    slot[:5] = torch.tensor([K, -1, K + 3, 0, K - 1], device=dev, dtype=torch.int32)
    before = opponent_actor_forward.launches
    k = opponent_actor_forward(obs, slot, stack)
    torch.cuda.synchronize()
    assert opponent_actor_forward.launches == before + 1
    p = opponent_actor_forward_plain(obs, slot, stack)
    assert torch.equal(k[:3], torch.zeros_like(k[:3]))  # out-of-range slots: zeros
    torch.testing.assert_close(k, p, rtol=1e-4, atol=1e-4)


def k8(logits, values, mb, ent_coef, cfg, fn=ppo_loss_forward):
    """K8 (or ``fn``, its plain version) with the entropy coefficient as a
    0-dim device tensor and a fresh ``LossBook``."""
    dev = logits.device
    return fn(logits, values, mb, torch.full((), ent_coef, device=dev), cfg, LossBook.create(dev))


def loss_batch(g, dev, M, A):
    logits = torch.randn(M, A, generator=g, device=dev) * 2
    n_masked = torch.randint(0, A, (M, 1), generator=g, device=dev)
    mask = (torch.rand(M, A, generator=g, device=dev).argsort(1).argsort(1) >= n_masked).float()
    logp = torch.log_softmax(logits + torch.where(mask > 0, 0.0, -1e9), -1)
    actions = torch.multinomial(mask, 1, generator=g)[:, 0].to(torch.int32)
    old_lp = logp.gather(1, actions.long()[:, None])[:, 0] + torch.randn(M, generator=g,
                                                                        device=dev) * 0.2
    values = torch.randn(M, generator=g, device=dev)
    mb = {
        "actions": actions, "old_log_probs": old_lp,
        "advantages": torch.randn(M, generator=g, device=dev) * 2 + 0.3,
        "returns": torch.randn(M, generator=g, device=dev),
        "old_values": values + torch.randn(M, generator=g, device=dev) * 0.3,
        "valid": (torch.rand(M, generator=g, device=dev) < 0.8).float(),
        "action_masks": mask,
    }
    return logits, values, mb


@pytest.mark.parametrize("M,A,clip_value", [(65536, 7, False), (65536, 7, True),
                                            (131072, 2, False), (1000, 7, True)])
def test_ppo_loss_kernel_matches_plain(dev, M, A, clip_value):
    g = torch.Generator(device=dev).manual_seed(M + A)
    logits, values, mb = loss_batch(g, dev, M, A)
    cfg = PPOUpdateConfig(clip_epsilon=0.1, clip_value=clip_value)
    before = ppo_loss.launches
    k = k8(logits, values, mb, 0.05, cfg)
    torch.cuda.synchronize()
    assert ppo_loss.launches == before + 1
    p = k8(logits, values, mb, 0.05, cfg, ppo_loss_plain)
    torch.testing.assert_close(k[0], p[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(k[1], p[1], rtol=1e-5, atol=1e-6)
    for a, b in zip(k[2:], p[2:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("n", [4739, 311304])
@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_adam_kernel_matches_plain(dev, n, scale):
    """Three steps below and above the max norm; below it (no clip) K9's
    parameters and moments are the plain version's bit for bit: each of
    its operations is rounded on its own, as the plain version's are."""
    g = torch.Generator(device=dev).manual_seed(n)
    p_k = torch.randn(n, generator=g, device=dev)
    mu_k, nu_k = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    p_p, mu_p, nu_p = p_k.clone(), mu_k.clone(), nu_k.clone()
    c_k, c_p = (torch.zeros((), dtype=torch.int32, device=dev) for _ in range(2))
    kw = dict(lr=torch.full((), 1e-3, device=dev), run=torch.ones((), dtype=torch.int32,
                                                                  device=dev),
              max_grad_norm=0.5, eps=1e-5)
    for count in (1, 2, 3):
        grads = torch.randn(n, generator=g, device=dev) * scale / n ** 0.5
        before = clip_adam.launches
        clip_adam(p_k, grads, mu_k, nu_k, **kw, count=c_k, partial=clip_adam_scratch(dev))
        torch.cuda.synchronize()
        assert clip_adam.launches == before + 1
        clip_adam_plain(p_p, grads, mu_p, nu_p, **kw, count=c_p)
        assert int(c_k) == int(c_p) == count
    for a, b in ((p_k, p_p), (mu_k, mu_p), (nu_k, nu_p)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7 * float(b.abs().max()))
        assert scale > 1 or torch.equal(a, b)


@pytest.mark.parametrize("n", [4739, 311304, 873778, 873781])
@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_adam_kernel_is_bit_identical_across_calls_and_on_a_graph_replay(dev, n, scale):
    """One K9 step from the same buffers: eagerly twice, then captured
    into a CUDA graph and replayed; every buffer equal bit for bit, and
    within the plain version's tolerance."""
    g = torch.Generator(device=dev).manual_seed(n)
    start = [torch.randn(n, generator=g, device=dev),
             torch.randn(n, generator=g, device=dev) * scale / n ** 0.5,
             torch.randn(n, generator=g, device=dev) * 1e-3,
             torch.rand(n, generator=g, device=dev) * 1e-6,
             torch.full((), 3, dtype=torch.int32, device=dev)]
    kw = dict(lr=torch.full((), 1e-3, device=dev), max_grad_norm=0.5, eps=1e-5,
              run=torch.ones((), dtype=torch.int32, device=dev))
    partial = clip_adam_scratch(dev)

    def step(bufs):
        clip_adam(bufs[0], bufs[1], bufs[2], bufs[3], count=bufs[4], **kw, partial=partial)

    runs = []
    for _ in range(2):
        bufs = [t.clone() for t in start]
        step(bufs)
        runs.append(bufs)
    graph_bufs = [t.clone() for t in start]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step([t.clone() for t in start])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(graph_bufs)
    for t, s0 in zip(graph_bufs, start):
        t.copy_(s0)
    before = clip_adam.launches
    graph.replay()
    torch.cuda.synchronize()
    assert clip_adam.launches == before  # a replay runs no wrapper
    plain = [t.clone() for t in start]
    clip_adam_plain(*plain[:4], count=plain[4], **kw)
    assert int(runs[0][4]) == int(runs[1][4]) == int(graph_bufs[4]) == int(plain[4]) == 4
    for i in (0, 2, 3):
        assert torch.equal(runs[0][i], runs[1][i])
        assert torch.equal(runs[0][i], graph_bufs[i])
        torch.testing.assert_close(runs[0][i], plain[i], rtol=1e-5,
                                   atol=1e-7 * float(plain[i].abs().max()))


def test_clip_adam_kernel_refuses_what_it_cannot_take(dev):
    z = torch.zeros(9, device=dev)
    kw = dict(lr=torch.full((), 1e-3, device=dev), count=torch.zeros((), dtype=torch.int32,
                                                                     device=dev),
              run=torch.ones((), dtype=torch.int32, device=dev), max_grad_norm=0.5, eps=1e-5)
    with pytest.raises(ValueError, match="scratch"):
        clip_adam(z[:8], z[:8], z[:8], z[:8], **kw)
    with pytest.raises(ValueError, match="16-byte aligned"):
        clip_adam(z[1:], z[:8], z[:8], z[:8], **kw, partial=clip_adam_scratch(dev))


@pytest.mark.parametrize("n", [4739, 873778])
def test_clip_adam_kernel_with_run_0_changes_nothing(dev, n):
    """K9 with its run flag 0: parameters, moments and count bit for bit
    as they were (every block returns before the grid barrier); with 1
    the step, and with any other nonzero flag the same step bit for bit."""
    g = torch.Generator(device=dev).manual_seed(n)
    start = [torch.randn(n, generator=g, device=dev),
             torch.randn(n, generator=g, device=dev) * 10.0 / n ** 0.5,
             torch.randn(n, generator=g, device=dev) * 1e-3,
             torch.rand(n, generator=g, device=dev) * 1e-6,
             torch.full((), 7, dtype=torch.int32, device=dev)]
    kw = dict(lr=torch.full((), 1e-3, device=dev), max_grad_norm=0.5, eps=1e-5,
              partial=clip_adam_scratch(dev))
    outs = {}
    for name, run in (("off", 0), ("on", 1), ("two", 2)):
        bufs = [t.clone() for t in start]
        flag = torch.full((), run, dtype=torch.int32, device=dev)
        clip_adam(*bufs[:4], count=bufs[4], run=flag, **kw)
        torch.cuda.synchronize()
        outs[name] = bufs
    for i in (0, 2, 3, 4):
        assert torch.equal(outs["off"][i], start[i])
        assert torch.equal(outs["on"][i], outs["two"][i])
    assert int(outs["on"][4]) == 8


def test_adam_bias_corrections_are_the_host_expression(dev):
    """The table K9 reads on the card holds float32(1 - b^count), formed on
    the host in double, for every count 1..100000 (past its end the last
    entry, 1.0f)."""
    table = adam_bias_table(dev).cpu()
    counts = range(1, 100001)
    cols = torch.tensor([min(c, ADAM_BIAS_LEN - 1) for c in counts])
    for row, b in ((0, ADAM_B1), (1, ADAM_B2)):
        want = torch.tensor([1.0 - b ** c for c in counts], dtype=torch.float64).float()
        assert torch.equal(table[row, cols], want)


@pytest.mark.parametrize("count", [0, 163, 17319, 32766, 99999])
def test_clip_adam_kernel_matches_plain_at_every_count(dev, count):
    """One step from Adam counts on both sides of the corrections' 1.0f
    rounding and the table's end."""
    n = 311304
    g = torch.Generator(device=dev).manual_seed(count)
    start = [torch.randn(n, generator=g, device=dev),
             torch.randn(n, generator=g, device=dev) * 1e-3 / n ** 0.5,
             torch.randn(n, generator=g, device=dev) * 1e-3,
             torch.rand(n, generator=g, device=dev) * 1e-6,
             torch.full((), count, dtype=torch.int32, device=dev)]
    kw = dict(lr=torch.full((), 3e-4, device=dev), max_grad_norm=0.5, eps=1e-5,
              run=torch.ones((), dtype=torch.int32, device=dev))
    k, p = [t.clone() for t in start], [t.clone() for t in start]
    clip_adam(*k[:4], count=k[4], **kw, partial=clip_adam_scratch(dev))
    clip_adam_plain(*p[:4], count=p[4], **kw)
    assert int(k[4]) == int(p[4]) == count + 1
    for i in (0, 2, 3):
        torch.testing.assert_close(k[i], p[i], rtol=1e-5, atol=1e-7 * float(p[i].abs().max()))


def episode_logs(g, dev, T, E, P, rate=0.05):
    kinds = torch.randint(0, 4, (T, E), generator=g, device=dev)
    places = torch.randint(1, P + 1, (T, E, P), generator=g, device=dev, dtype=torch.int32)
    places[kinds == 1] = 1  # all tied first: a draw
    places[kinds == 2] = 0  # the no-outcome sentinel
    return EpisodeLog(
        completed=(torch.rand(T, E, generator=g, device=dev) < rate).float(),
        total_rewards=torch.randn(T, E, P, generator=g, device=dev),
        length=torch.randint(1, 43, (T, E), generator=g, device=dev, dtype=torch.int32),
        outcome=places, active_players=torch.full((T, E), P, dtype=torch.int32, device=dev),
    )


@pytest.mark.parametrize("T,E,P,L", [(64, 4096, 2, 3072), (64, 4096, 2, None),
                                     (128, 4096, 1, None), (5, 33, 4, 20), (3, 7, 2, 1)])
def test_episode_stats_kernel_matches_plain(dev, T, E, P, L):
    g = torch.Generator(device=dev).manual_seed(T * P)
    logs = episode_logs(g, dev, T, E, P)
    before = summarize_episode_logs.launches
    k = summarize_episode_logs(logs, P, num_envs=L)
    torch.cuda.synchronize()
    assert summarize_episode_logs.launches == before + 1
    cut = EpisodeLog(**{f: getattr(logs, f)[:, :L] for f in logs.__dataclass_fields__})
    assert_summaries_match(k, summarize_episode_logs_plain(logs if L is None else cut, P))


def assert_summaries_match(k, p):
    assert set(k) == set(p)
    for key in ("count", "len_sum", "draws", "ret0_max", "ret0_min"):
        assert torch.equal(k[key], p[key]), key
    for key in ("ret_sum", "pts_sum"):
        torch.testing.assert_close(k[key], p[key], rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("rate", [0.0, 1.0])
@pytest.mark.parametrize("T,E,P,L", [(64, 4096, 4, 1), (64, 4096, 4, 2867), (5, 4096, 2, 1),
                                     (3, 4097, 4, 2867)])
def test_episode_stats_kernel_with_none_or_all_completed(dev, T, E, P, L, rate):
    """K10 on a learner block of 1 and of 2867 columns (a ragged float4
    tail; E = 4097 rows off 16 bytes), no entry completed (count 0, the
    extrema -inf and +inf) or all of them (a warp's list full)."""
    g = torch.Generator(device=dev).manual_seed(T + L)
    logs = episode_logs(g, dev, T, E, P, rate)
    if rate == 1.0:
        logs.completed.fill_(1.0)
    k = summarize_episode_logs(logs, P, num_envs=L)
    cut = EpisodeLog(**{f: getattr(logs, f)[:, :L] for f in logs.__dataclass_fields__})
    assert_summaries_match(k, summarize_episode_logs_plain(cut, P))
    if rate == 0.0:
        assert float(k["count"]) == 0.0
        assert float(k["ret0_max"]) == float("-inf") and float(k["ret0_min"]) == float("inf")


@pytest.mark.parametrize("T,P,L", [(64, 2, 3072), (64, 4, 2867), (128, 4, 3072)])
def test_episode_stats_kernel_gives_the_same_bits_twice(dev, T, P, L):
    """Partials added in a fixed order, the ticket put back: two calls in
    a row give the same bits."""
    g = torch.Generator(device=dev).manual_seed(T * P)
    logs = episode_logs(g, dev, T, 4096, P)
    first = {k: v.clone() for k, v in summarize_episode_logs(logs, P, num_envs=L).items()}
    second = summarize_episode_logs(logs, P, num_envs=L)
    for key in first:
        assert torch.equal(first[key], second[key]), key


def test_episode_stats_kernel_replays_from_a_cuda_graph(dev):
    """One launch on the device's scratch captures: two replays each equal
    bit for bit to the eager call (the last block put the ticket back),
    and no launch counted."""
    g = torch.Generator(device=dev).manual_seed(5)
    logs = episode_logs(g, dev, 128, 4096, 4)
    eager = summarize_episode_logs(logs, 4, num_envs=3072)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        summarize_episode_logs(logs, 4, num_envs=3072)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = summarize_episode_logs(logs, 4, num_envs=3072)
    before = summarize_episode_logs.launches
    for _ in range(2):
        for t in captured.values():
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for key in eager:
            assert torch.equal(captured[key], eager[key]), key
    assert summarize_episode_logs.launches == before


def test_episode_stats_scratch_first_made_inside_a_capture_raises(dev, monkeypatch):
    """The scratch is made at the first call on a device; a first call
    inside a capture raises rather than make it in the graph's pool."""
    from burn_ppo_torch.ppo import episode_stats

    monkeypatch.setattr(episode_stats, "_SCRATCH", {})
    g = torch.Generator(device=dev).manual_seed(6)
    logs = episode_logs(g, dev, 4, 64, 2)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        with torch.cuda.graph(graph):
            summarize_episode_logs(logs, 2)
    assert episode_stats._SCRATCH == {}
    torch.cuda.synchronize()
    assert float(summarize_episode_logs(logs, 2)["count"]) == float(logs.completed.sum())
    assert list(episode_stats._SCRATCH) == [logs.completed.device]


@pytest.mark.parametrize("E,n", [(1, 4), (257, 2), (4096, 4), (512, 6)])
def test_skull_kernel_matches_plain_exactly(dev, E, n):
    """K11 against the plain step along a walk of 150 steps, every output
    equal bit for bit (the packed state whole); forced discards, finished
    games fed back in and a shaping coefficient on half the envs."""
    g = torch.Generator(device=dev).manual_seed(E + n)
    env = Skull(n)
    empty = torch.empty(E, 0, device=dev)
    state = env.reset(empty)
    state = SkullState(state.ints, (torch.arange(E, device=dev) % 2) * 0.05)
    acc = EpisodeAccumulator.zero(E, n, dev)
    dones = 0

    def assert_equal(k, p):
        pairs = [(k.state.ints, p.state.ints), (k.state.shaping_coef, p.state.shaping_coef)]
        pairs += [(getattr(k.log, f), getattr(p.log, f))
                  for f in ("completed", "total_rewards", "length", "outcome", "active_players")]
        pairs += [(k.acc.reward_sum, p.acc.reward_sum), (k.acc.length, p.acc.length),
                  (k.rewards, p.rewards), (k.done, p.done), (k.obs, p.obs), (k.mask, p.mask),
                  (k.priv, p.priv)]
        for a, b in pairs:
            assert a.dtype == b.dtype and torch.equal(a, b)

    for _ in range(150):
        fd = torch.randint(0, 2, (E,), generator=g, device=dev, dtype=torch.int32)
        fd = torch.where(torch.rand(E, generator=g, device=dev) < 0.15, fd, -1)
        over = state.game_over | (torch.rand(E, generator=g, device=dev) < 0.003)
        state = SkullState.of(**{**state.fields(), "forced_discard": fd, "game_over": over})
        action = walk_actions(env.action_mask(state), g)
        u = torch.rand(E, generator=g, device=dev)
        before = skull_step_autoreset.launches
        k = env.step_autoreset(state, acc, action, empty, u)
        torch.cuda.synchronize()
        assert skull_step_autoreset.launches == before + 1
        p = autoreset_step(env, state, acc, action, empty, u)
        assert_equal(k, p)
        dones += int(p.done.sum())
        state, acc = p.state, p.acc
    assert dones > 0


def test_skull_kernel_refuses_what_it_cannot_take(dev):
    """A packed state of the wrong width or type, or not contiguous, or not
    16-byte aligned, is refused before the launch."""
    E = 64
    env = Skull(4)
    empty = torch.empty(E, 0, device=dev)
    state = env.reset(empty)
    acc = EpisodeAccumulator.zero(E, 4, dev)
    action = torch.zeros(E, dtype=torch.int32, device=dev)
    u = torch.rand(E, device=dev)
    before = skull_step_autoreset.launches
    wide = torch.zeros(E, state.ints.shape[1] + 4, dtype=torch.int32, device=dev)
    wide[:, :state.ints.shape[1]] = state.ints
    flat = torch.zeros(E * state.ints.shape[1] + 1, dtype=torch.int32, device=dev)
    shifted = flat[1:].view(E, -1)
    shifted.copy_(state.ints)
    for ints, err in ((state.ints[:, :-1].contiguous(), ValueError),
                      (state.ints.to(torch.int64), TypeError),
                      (wide[:, :state.ints.shape[1]], ValueError),
                      (shifted, ValueError)):
        with pytest.raises(err):
            env.step_autoreset(SkullState(ints, state.shaping_coef), acc, action, empty, u)
    with pytest.raises(TypeError):
        env.step_autoreset(state, acc, action.to(torch.int64), empty, u)
    assert skull_step_autoreset.launches == before


@pytest.mark.parametrize("E,P", [(4096, 1), (4096, 4), (5, 3)])
def test_return_norm_roll_kernel_matches_plain_exactly(dev, E, P):
    g = torch.Generator(device=dev).manual_seed(E + P)
    returns = torch.randn(E, P, generator=g, device=dev)
    rewards = torch.randn(E, generator=g, device=dev)
    acting = torch.randint(0, P, (E,), generator=g, device=dev, dtype=torch.int32)
    dones = (torch.rand(E, generator=g, device=dev) < 0.1).float()
    before = return_norm_roll.launches
    k = return_norm_roll(returns, rewards, acting, dones, 0.99)
    torch.cuda.synchronize()
    assert return_norm_roll.launches == before + 1
    p = return_norm_roll_plain(returns, rewards, acting, dones, 0.99)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


def return_norm_state(dev, filled: bool) -> ReturnNormState:
    z = torch.zeros((), device=dev)
    return ReturnNormState(returns=torch.zeros(1, 1, device=dev), mean=z + (0.4 if filled else 0),
                           m2=z + (9e5 if filled else 0), count=z + (1e5 if filled else 0),
                           scratch=return_norm_scratch(dev))


@pytest.mark.parametrize("filled", [False, True])
@pytest.mark.parametrize("valid", ["none", "mask", "zeros"])
@pytest.mark.parametrize("N", [1, 2, 2047, 100003, 524288, 524289])
def test_return_norm_finalize_kernel_matches_plain(dev, N, valid, filled):
    """The f64 stats to 1e-12 relative, the normalized rewards to f32
    rounding (2 ulp), the pass-through below a count of 2 exact; one
    launch; a second call equal bit for bit."""
    g = torch.Generator(device=dev).manual_seed(N)
    samples = torch.randn(N, generator=g, device=dev) * 3 + 1
    rewards = torch.randn(N, generator=g, device=dev)
    w = {"none": None, "mask": (torch.rand(N, generator=g, device=dev) < 0.7).float(),
         "zeros": torch.zeros(N, device=dev)}[valid]
    state = return_norm_state(dev, filled)
    before = return_norm_finalize.launches
    ks, kn = return_norm_finalize_f64(state, samples, rewards, 10.0, w)
    torch.cuda.synchronize()
    assert return_norm_finalize.launches == before + 1
    again = return_norm_finalize_f64(state, samples, rewards, 10.0, w)
    assert torch.equal(ks, again[0]) and torch.equal(kn, again[1])
    ps, pn = return_norm_finalize_f64_plain(state, samples, rewards, 10.0, w)
    assert torch.all((ks - ps).abs() <= 1e-12 * ps.abs())
    assert torch.all((kn - pn).abs() <= 2.4e-7 * pn.abs())


def test_return_norm_finalize_kernel_leaves_the_state_without_valid_samples(dev):
    N = 1000
    state = return_norm_state(dev, True)
    state.mean, state.m2, state.count = state.mean + 0.1234567, state.m2 + 7.654321, state.count + 77
    new, _ = return_norm_finalize(state, torch.randn(N, device=dev), torch.randn(N, device=dev),
                                     10.0, torch.zeros(N, device=dev))
    torch.cuda.synchronize()
    for f in ("mean", "m2", "count"):
        assert torch.equal(getattr(new, f), getattr(state, f))


def test_return_norm_finalize_kernel_takes_misaligned_views(dev):
    """Inputs and output off a 16-byte boundary take the scalar loads."""
    N = 9001
    g = torch.Generator(device=dev).manual_seed(1)
    buf = torch.randn(2 * N + 2, generator=g, device=dev)
    samples, rewards = buf[1:N + 1], buf[N + 2:]
    state = return_norm_state(dev, False)
    ks, kn = return_norm_finalize_f64(state, samples, rewards)
    ps, pn = return_norm_finalize_f64_plain(state, samples, rewards)
    assert torch.all((ks - ps).abs() <= 1e-12 * ps.abs())
    assert torch.all((kn - pn).abs() <= 2.4e-7 * pn.abs())


def test_return_norm_finalize_kernel_replays_from_a_cuda_graph(dev):
    """One launch on the state's scratch captures: a replay equal bit for
    bit to the eager call."""
    N = 524288
    g = torch.Generator(device=dev).manual_seed(2)
    samples = torch.randn(N, generator=g, device=dev)
    rewards = torch.randn(N, generator=g, device=dev)
    valid = (torch.rand(N, generator=g, device=dev) < 0.75).float()
    state = return_norm_state(dev, True)
    eager = return_norm_finalize_f64(state, samples, rewards, 10.0, valid)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        return_norm_finalize_f64(state, samples, rewards, 10.0, valid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = return_norm_finalize_f64(state, samples, rewards, 10.0, valid)
    before = return_norm_finalize.launches
    for t in captured:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert return_norm_finalize.launches == before
    assert torch.equal(captured[0], eager[0]) and torch.equal(captured[1], eager[1])


def test_return_norm_finalize_kernel_refuses_a_state_without_scratch(dev):
    state = return_norm_state(dev, False)
    state.scratch = None
    with pytest.raises(ValueError, match="scratch"):
        return_norm_finalize_f64(state, torch.zeros(8, device=dev), torch.zeros(8, device=dev))


@pytest.mark.parametrize("E", [1, 3, 5, 257, 4096])
def test_liars_dice_kernel_matches_plain_exactly(dev, E):
    """K13 against the plain step along a walk of 200 steps, every output
    equal bit for bit; unmasked and out-of-range actions, finished games fed
    back in and a shaping coefficient on half the envs."""
    g = torch.Generator(device=dev).manual_seed(E)
    env = LiarsDice()
    state = env.reset(torch.rand(E, 8, generator=g, device=dev))
    state = LiarsDiceState(state.ints, (torch.arange(E, device=dev) % 2) * 0.05)
    acc = EpisodeAccumulator.zero(E, 4, dev)
    dones = 0
    for _ in range(200):
        over = state.game_over | (torch.rand(E, generator=g, device=dev) < 0.003)
        state = LiarsDiceState.of(state.shaping_coef, **{**state.fields(), "game_over": over})
        action = liars_dice_walk(env.action_mask(state), g)
        u_reset = torch.rand(E, 8, generator=g, device=dev)
        u_step = torch.rand(E, 8, generator=g, device=dev)
        before = liars_dice_step_autoreset.launches
        k = env.step_autoreset(state, acc, action, u_reset, u_step)
        torch.cuda.synchronize()
        assert liars_dice_step_autoreset.launches == before + 1
        p = autoreset_step(env, state, acc, action, u_reset, u_step)
        assert_steps_equal(k, p)
        dones += int(p.done.sum())
        state, acc = p.state, p.acc
    assert dones > 0


# K7 at every tower the pool runs: (obs, hidden width, hidden layers, head).
OPPONENT_TOWERS = {
    "c4_mlp512x2": (86, 512, 2, 7),
    "ld_mlp512x3": (270, 512, 3, 49),
    "skull_ctde256x3": (135, 256, 3, 33),
    "ld_ctde256x2": (270, 256, 2, 49),
    "skull_mlp256x3": (135, 256, 3, 33),
}


def opponent_case(g, dev, tower, act, normed, Ep, K=8):
    D, H, depth, A = OPPONENT_TOWERS[tower]
    stack = make_opponents(g, dev, K, act, D=D, H=H, A=A, depth=depth)
    if not normed:
        stack.norm = None
    obs = torch.randn(Ep, D, generator=g, device=dev) * 2.0 + 0.5
    slot = torch.randint(0, K, (Ep,), generator=g, device=dev, dtype=torch.int32)
    return obs, slot, stack


def assert_opponent_close(k, p):
    assert bool(torch.all((k - p).abs() <= 1e-4 + 1e-4 * p.abs())), float((k - p).abs().max())


@pytest.mark.parametrize("tower", sorted(OPPONENT_TOWERS))
@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("normed", [True, False])
def test_opponent_actor_kernel_takes_every_pool_tower(dev, tower, act, normed):
    """|kernel - plain| <= 1e-4 + 1e-4 |plain| (3xTF32 keeps f32 accuracy)."""
    g = torch.Generator(device=dev).manual_seed(len(tower) * 7 + normed)
    obs, slot, stack = opponent_case(g, dev, tower, act, normed, Ep=1024)
    before = opponent_actor_forward.launches
    k = opponent_actor_forward(obs, slot, stack)
    torch.cuda.synchronize()
    assert opponent_actor_forward.launches == before + 1
    assert_opponent_close(k, opponent_actor_forward_plain(obs, slot, stack))


@pytest.mark.parametrize("tiling", range(len(OPPONENT_TILINGS)))
@pytest.mark.parametrize("tower", ["c4_mlp512x2", "skull_ctde256x3"])
def test_opponent_actor_kernel_matches_plain_at_every_tiling(dev, tiling, tower):
    g = torch.Generator(device=dev).manual_seed(tiling)
    obs, slot, stack = opponent_case(g, dev, tower, "relu", True, Ep=1229)
    k = opponent_actor_forward(obs, slot, stack, tiling=tiling)
    torch.cuda.synchronize()
    assert_opponent_close(k, opponent_actor_forward_plain(obs, slot, stack))


@pytest.mark.parametrize("Ep", [37, 1229])
@pytest.mark.parametrize("tiling", range(len(OPPONENT_TILINGS)))
def test_opponent_actor_kernel_with_empty_small_and_out_of_range_slots(dev, Ep, tiling):
    """Slots 1, 4 and 6 empty, slot 2 with 3 rows (under a tile), rows of
    slots -1, 8 and 40 (outside [0, 8)) read zeros; Ep not a multiple of
    any tile."""
    g = torch.Generator(device=dev).manual_seed(Ep + tiling)
    obs, slot, stack = opponent_case(g, dev, "ld_ctde256x2", "tanh", False, Ep=Ep)
    used = torch.tensor([0, 3, 5, 7], device=dev, dtype=torch.int32)
    slot = used[torch.randint(0, 4, (Ep,), generator=g, device=dev)]
    slot[:3] = 2
    slot[5:8] = torch.tensor([-1, 8, 40], device=dev, dtype=torch.int32)
    k = opponent_actor_forward(obs, slot, stack, tiling=tiling)
    torch.cuda.synchronize()
    p = opponent_actor_forward_plain(obs, slot, stack)
    assert torch.equal(k[5:8], torch.zeros_like(k[5:8]))
    assert_opponent_close(k, p)


def test_opponent_actor_kernel_refuses_what_it_cannot_take(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    obs = torch.rand(16, 86, generator=g, device=dev)
    slot = torch.zeros(16, dtype=torch.int32, device=dev)
    for kwargs, what in (({"H": 100}, "hidden widths"), ({"A": 65}, "head width"),
                         ({"depth": 4}, "layers")):
        stack = make_opponents(g, dev, 2, "relu", **kwargs)
        with pytest.raises(ValueError, match=what):
            opponent_actor_forward(obs, slot, stack)
    wide = make_opponents(g, dev, 2, "relu", D=600)
    with pytest.raises(ValueError, match="obs width"):
        opponent_actor_forward(torch.rand(16, 600, device=dev), slot, wide)


def tie_batch(g, dev, M, A):
    """A loss batch with exact ties in half its rows: two legal actions of
    equal logits (log-prob -log 2), old log-probs that make the ratio
    exactly 1 + eps or 1 - eps on the card, and values whose clipped and
    unclipped errors square equally (e1 = -e2) or sit on the clip edge."""
    logits, values, mb = loss_batch(g, dev, M, A)
    n = M // 2
    mask = mb["action_masks"]
    mask[:n] = 0.0
    mask[:n, :2] = 1.0
    logits[:n, 1] = logits[:n, 0]
    mb["actions"][:n] = 0
    eps = 0.25
    lp = torch.log_softmax(logits[:n] + torch.where(mask[:n] > 0, 0.0, -1e9), -1)[:, 0]
    assert bool(torch.all(lp == lp[0]))
    for rows, target in ((slice(0, n // 2), 1.0 + eps), (slice(n // 2, n), 1.0 - eps)):
        want = torch.tensor(target, dtype=torch.float32, device=dev)
        old = lp[0] - torch.log(want)
        for _ in range(200):
            r = torch.exp(lp[0] - old)
            if r == want:
                break
            old = torch.nextafter(old, old + (1.0 if r > want else -1.0))
        assert torch.exp(lp[0] - old) == want
        mb["old_log_probs"][rows] = old
    val = torch.randint(-16, 16, (n,), generator=g, device=dev).float() / 8.0
    values[:n] = val
    edge = torch.arange(n, device=dev) % 2 == 0
    mb["old_values"][:n] = torch.where(edge, val - eps, val - 1.0)
    mb["returns"][:n] = torch.where(edge, mb["returns"][:n], val - 0.375)
    return logits, values, mb, PPOUpdateConfig(clip_epsilon=eps, clip_value=True)


def assert_loss_close(k, p):
    torch.testing.assert_close(k[0], p[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(k[1], p[1], rtol=1e-5, atol=1e-6)
    for a, b in zip(k[2:], p[2:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("A", [2, 33, 49])
@pytest.mark.parametrize("M", [1000, 65537])
@pytest.mark.parametrize("case", ["random", "ties", "all_invalid"])
def test_ppo_loss_kernel_at_every_action_count(dev, A, M, case):
    g = torch.Generator(device=dev).manual_seed(A * M)
    if case == "ties":
        logits, values, mb, cfg = tie_batch(g, dev, M, A)
    else:
        logits, values, mb = loss_batch(g, dev, M, A)
        cfg = PPOUpdateConfig(clip_epsilon=0.1, clip_value=True)
        if case == "all_invalid":
            mb["valid"].zero_()
    k = k8(logits, values, mb, 0.05, cfg)
    torch.cuda.synchronize()
    assert_loss_close(k, k8(logits, values, mb, 0.05, cfg, ppo_loss_plain))
    if case == "all_invalid":
        assert not bool(k[2].any()) and not bool(k[3].any())


@pytest.mark.parametrize("M,A", [(65536, 7), (65536, 49), (1000, 33)])
def test_ppo_loss_kernel_is_bit_identical_across_calls(dev, M, A):
    g = torch.Generator(device=dev).manual_seed(M - A)
    logits, values, mb = loss_batch(g, dev, M, A)
    cfg = PPOUpdateConfig(clip_epsilon=0.1, clip_value=True)
    first = k8(logits, values, mb, 0.05, cfg)
    second = k8(logits, values, mb, 0.05, cfg)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_ppo_loss_kernel_refuses_too_many_actions(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    logits, values, mb = loss_batch(g, dev, 64, 65)
    with pytest.raises(ValueError, match="1 to 64 actions"):
        k8(logits, values, mb, 0.05, PPOUpdateConfig())


def test_ppo_loss_kernel_takes_the_entropy_coefficient_on_the_device(dev):
    """The 0-dim device ent_coef is read at launch: a new value written
    into the same tensor gives the plain version's values at that value,
    and the bits of a fresh tensor holding it."""
    g = torch.Generator(device=dev).manual_seed(3)
    logits, values, mb = loss_batch(g, dev, 65536, 49)
    cfg = PPOUpdateConfig(clip_value=True)
    ent = torch.full((), 0.03, device=dev)
    a = ppo_loss_forward(logits, values, mb, ent, cfg, LossBook.create(dev))
    assert_loss_close(a, k8(logits, values, mb, 0.03, cfg, ppo_loss_plain))
    ent.fill_(0.07)
    b = ppo_loss_forward(logits, values, mb, ent, cfg, LossBook.create(dev))
    assert not torch.equal(a[2], b[2])
    for x, y in zip(b, k8(logits, values, mb, 0.07, cfg)):
        assert torch.equal(x, y)
    assert_loss_close(b, k8(logits, values, mb, 0.07, cfg, ppo_loss_plain))


def test_ppo_loss_kernel_bookkeeping_matches_the_plain_twin(dev):
    """A sequence of minibatches (ordinary, all-invalid, one whose
    approx_kl passes target_kl, then more after the stop) through K8 with
    a book and through the plain version with another: the run flag after
    each, the minibatches counted, the stop flag and the metric sums."""
    g = torch.Generator(device=dev).manual_seed(5)
    batches = [loss_batch(g, dev, 16384, 33) for _ in range(5)]
    batches[1][2]["valid"] = torch.zeros(16384, device=dev)
    # target_kl 0: the first minibatch that runs stops the rest.
    for target_kl in (None, 0.0):
        cfg = PPOUpdateConfig(target_kl=target_kl)
        kb, pb = LossBook.create(dev), LossBook.create(dev)
        runs = []
        for logits, values, mb in batches:
            ent = torch.full((), 0.02, device=dev)
            k = ppo_loss_forward(logits, values, mb, ent, cfg, kb, True)
            ppo_loss_plain(logits, values, mb, ent, cfg, pb, True)
            runs.append((int(kb.run), int(pb.run)))
            assert torch.equal(kb.out[1:], k[1])
        assert all(a == b for a, b in runs), runs
        want = [1, 0, 1, 1, 1] if target_kl is None else [1, 0, 0, 0, 0]
        assert [a for a, _ in runs] == want
        assert float(kb.count) == float(pb.count) == sum(want)
        assert int(kb.stop) == int(pb.stop) == (0 if target_kl is None else 1)
        torch.testing.assert_close(kb.sums, pb.sums, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The rollout as one captured CUDA graph (ppo/rollout_graph.py)
# ---------------------------------------------------------------------------


def _rollout_setup(dev, env_name, E, T, seed=0):
    """A trainer's rollout inputs on the card: the config's network (its
    parameters in the flat buffer, as ``AdamState.create`` leaves them),
    the carry, obs-norm stats from random obs, and a seeded generator."""
    from burn_ppo_torch.config import Config
    from burn_ppo_torch.envs import make_env
    from burn_ppo_torch.ppo.rollout import TorchRandomSource, init_rollout_carry
    from burn_ppo_torch.ppo.update import AdamState
    from burn_ppo_torch.train import build_network_for_env

    hidden = {"cartpole": 64, "connect_four": 128}[env_name]
    cfg = Config(env=env_name, num_envs=E, num_steps=T, hidden_size=hidden, num_hidden=2,
                 activation="relu", normalize_obs=True, seed=seed)
    env = make_env(env_name)
    net = build_network_for_env(env, cfg, torch.Generator().manual_seed(seed)).to(dev)
    AdamState.create(net)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    rng = TorchRandomSource(gen)
    carry = init_rollout_carry(env, E, rng, dev)
    D = env.spec.obs_dim
    norm = obs_norm_update_plain(ObsNormState.create(D, dev),
                                 torch.rand(64, D, generator=torch.Generator(device=dev)
                                            .manual_seed(seed + 2), device=dev) * 3.0)
    return cfg, env, net, rng, carry, norm


def _rollout_leaves(carry, batch, logs):
    from burn_ppo_torch.ppo.rollout_graph import state_leaves

    return state_leaves(carry) + state_leaves(batch) + state_leaves(logs)


@pytest.mark.parametrize("env_name,E,T", [("cartpole", 1024, 48), ("connect_four", 1024, 24)])
def test_graphed_rollout_equals_the_eager_loop_bit_for_bit(dev, env_name, E, T):
    """Three rollouts back to back from one generator state: the eager loop
    (``collect_rollouts``, fresh buffers) and the runner's graph replays
    give the same bits in every batch, log and carry tensor, and leave
    the generator at the same offset; one capture, three replays, no
    wrapper counter moved by a replay."""

    from burn_ppo_torch.ppo.rollout import collect_rollouts
    from burn_ppo_torch.ppo.rollout_graph import RolloutGraph
    from burn_ppo_torch.train import rollout_runner

    cfg, env, net, rng, carry0, norm = _rollout_setup(dev, env_name, E, T)
    normalize = cfg.effective_normalize_returns(env.spec.num_players)
    runner = rollout_runner(env, cfg)
    RolloutGraph.reset_counts()
    eager_carry, graph_carry = carry0, carry0
    for _ in range(3):
        start = rng.generator.get_state()
        eager = collect_rollouts(net, env, eager_carry, norm, rng, num_steps=T, gamma=cfg.gamma,
                                 normalize_returns=normalize)
        want = [t.clone() for t in _rollout_leaves(*eager)]
        after = rng.generator.get_state()
        rng.generator.set_state(start)
        counts = [w.launches for w in (masked_sample, obs_norm_apply)]
        got = runner.run(net, graph_carry, norm, rng)
        torch.cuda.synchronize()
        assert torch.equal(rng.generator.get_state(), after)
        have = _rollout_leaves(*got)
        assert len(have) == len(want)
        for i, (a, b) in enumerate(zip(have, want)):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), i
        eager_carry = eager[0]
        graph_carry = got[0]
    assert runner.graph is not None and RolloutGraph.captures == 1 and RolloutGraph.replays == 3
    assert RolloutGraph.launches[masked_sample] == 3 * T
    # after the capture (warm-up included), the replays moved no counter
    assert [w.launches for w in (masked_sample, obs_norm_apply)] == counts


def test_graph_replays_draw_new_randoms_and_a_seed_repeats_its_run(dev):
    """Two replays from the same carry draw different randoms (the
    generator is registered with the graph and advances); two runners from
    the same seed give the same bits."""
    from burn_ppo_torch.train import rollout_runner

    runs = []
    for _ in range(2):
        cfg, env, net, rng, carry0, norm = _rollout_setup(dev, "cartpole", 512, 16, seed=4)
        runner = rollout_runner(env, cfg)
        first = [t.clone() for t in _rollout_leaves(*runner.run(net, carry0, norm, rng))]
        second = [t.clone() for t in _rollout_leaves(*runner.run(net, carry0, norm, rng))]
        runs.append((first, second))
        batch_1, batch_2 = first, second
        # same carry in, so the obs of step 0 agree; the sampled actions do not
        assert not all(torch.equal(a, b) for a, b in zip(batch_1, batch_2))
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(a, b)


def test_one_vs_pool_graph_replays_every_active_count_bit_for_bit(dev):
    """Connect Four against a padded stack of 4, the active count 1, 2, 4
    and a new rotation each rollout: one capture, and each replay equals
    the eager loop (``collect_rollouts_with_opponents``, the same draw rule
    for the reseat's device bound) bit for bit, the generator at the same
    offset and the reseats below the count."""
    from burn_ppo_torch.ppo.pool_rollout import (
        OpponentStack,
        PoolSeating,
        actor_params,
        collect_rollouts_with_opponents,
    )
    from burn_ppo_torch.ppo.rollout_graph import RolloutGraph, state_leaves
    from burn_ppo_torch.train import build_network_for_env, rollout_runner

    E, T, L, K = 1024, 16, 768, 4
    cfg, env, net, rng, carry0, norm = _rollout_setup(dev, "connect_four", E, T)
    seat0 = PoolSeating.create(E, L, env.spec.num_players, 1, rng)
    runner = rollout_runner(env, cfg, num_learner_envs=L)
    RolloutGraph.reset_counts()
    eager_in = graph_in = (carry0, seat0)
    for i, active in enumerate((1, 2, 4)):
        nets = [build_network_for_env(env, cfg, torch.Generator().manual_seed(10 * i + k)).to(dev)
                for k in range(K)]
        stack = OpponentStack.of([actor_params(n) for n in nets], None)
        start = rng.generator.get_state()
        eager = collect_rollouts_with_opponents(
            net, env, stack, *eager_in, norm, rng, num_steps=T, num_learner_envs=L,
            num_active=active, gamma=cfg.gamma)
        want = [t.clone() for t in state_leaves(list(eager))]
        after = rng.generator.get_state()
        rng.generator.set_state(start)
        got = runner.run(net, graph_in[0], norm, rng, seating=graph_in[1], opponents=stack,
                         num_active=active)
        torch.cuda.synchronize()
        assert torch.equal(rng.generator.get_state(), after)
        have = state_leaves(list(got))
        assert len(have) == len(want)
        for j, (a, b) in enumerate(zip(have, want)):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), (active, j)
        assert int(got[1].seat_opp[L:].max()) < active
        eager_in, graph_in = (eager[0], eager[1]), (got[0], got[1])
    assert RolloutGraph.captures == 1 and RolloutGraph.replays == 3


# ---------------------------------------------------------------------------
# The update as one captured CUDA graph (ppo/update_graph.py)
# ---------------------------------------------------------------------------


def _update_state(net, opt, runner):
    """What an update writes: parameters, moments, count, obs-norm stats."""
    from burn_ppo_torch.ppo.rollout_graph import state_leaves

    return [opt.flat_params, opt.flat_mu, opt.flat_nu, opt.count_tensor,
            *state_leaves(runner.obs_norm)]


def _update_case(dev, seed, target_kl):
    from burn_ppo_torch.ppo.update import AdamState
    from burn_ppo_torch.ppo.update_graph import UpdateRunner
    from burn_ppo_torch.train import rollout_runner

    cfg, env, net, rng, carry, norm = _rollout_setup(dev, "cartpole", 1024, 32, seed=seed)
    cfg.target_kl = target_kl
    opt = AdamState.create(net)
    return cfg, env, net, opt, rng, carry, norm, rollout_runner(env, cfg), UpdateRunner(env, cfg)


def test_graphed_update_equals_the_eager_loop_bit_for_bit(dev):
    """Three updates, each after a graphed rollout, with a KL stop that
    fires: from one saved state the eager loop (``UpdateRunner.eager``)
    and the runner's graph replay give the same parameters, moments,
    count, obs-norm stats, metrics and episode summaries bit for bit, and
    leave the generator at the same offset; one capture, three replays;
    the replays launch K8 in the minibatches that ran and no other (no
    minibatch is empty here), the graphs of the rest skipped."""
    from burn_ppo_torch.ppo.rollout_graph import state_leaves
    from burn_ppo_torch.ppo.update_graph import UpdateGraph

    cfg, env, net, opt, rng, carry, norm, runner, updater = _update_case(dev, 0, 0.002)
    UpdateGraph.reset_counts()
    lr, ent = 0.01, 0.01
    minibatches = []
    for _ in range(3):
        runner.run(net, carry, norm, rng)
        carry, norm = runner.carry, runner.obs_norm
        saved = [t.clone() for t in _update_state(net, opt, runner)]
        start = rng.generator.get_state()
        eager = updater.eager(net, opt, runner, rng, lr, ent)
        want = [t.clone() for t in _update_state(net, opt, runner) + state_leaves(
            [list(eager["metrics"].values()), list(eager["stats"].values())])]
        after = rng.generator.get_state()
        for t, s0 in zip(_update_state(net, opt, runner), saved):
            t.copy_(s0)
        rng.generator.set_state(start)
        got = updater.run(net, opt, runner, rng, lr, ent)
        torch.cuda.synchronize()
        have = _update_state(net, opt, runner) + state_leaves(
            [list(got["metrics"].values()), list(got["stats"].values())])
        assert len(have) == len(want)
        for i, (a, b) in enumerate(zip(have, want)):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), i
        assert torch.equal(rng.generator.get_state(), after)
        minibatches.append(float(got["metrics"]["num_minibatch_updates"]))
    assert UpdateGraph.captures == 1 and UpdateGraph.replays == 3
    total = cfg.num_epochs * cfg.num_minibatches
    assert min(minibatches) < total, minibatches
    launched = UpdateGraph.launches[ppo_loss]
    assert launched == sum(minibatches) and UpdateGraph.skipped == 3 * total - launched


def test_update_graph_replays_draw_new_permutations_and_a_seed_repeats_its_run(dev):
    """Two replays of one graph on the same inputs draw different epoch
    permutations (other parameters after the second); two runners from
    the same seed give the same bits."""
    runs = []
    for _ in range(2):
        cfg, env, net, opt, rng, carry, norm, runner, updater = _update_case(dev, 4, None)
        runner.run(net, carry, norm, rng)
        saved = [t.clone() for t in _update_state(net, opt, runner)]
        outs = []
        for _ in range(2):
            for t, s0 in zip(_update_state(net, opt, runner), saved):
                t.copy_(s0)
            updater.run(net, opt, runner, rng, 0.003, 0.01)
            outs.append([t.clone() for t in _update_state(net, opt, runner)])
        assert updater.graph is not None
        assert not torch.equal(outs[0][0], outs[1][0])
        runs.append(outs)
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(a, b)


def test_a_train_step_does_not_sync_with_the_host(dev):
    """A CartPole train step, both graphs captured, under
    ``torch.cuda.set_sync_debug_mode("error")``: no stream or device
    synchronize from the rollout's replay to the update's (the host's
    wait for the stop flag between minibatch graphs is an event query,
    which this mode does not see)."""
    from burn_ppo_torch.ppo.update import AdamState
    from burn_ppo_torch.train import TrainState, make_train_step

    cfg, env, net, rng, carry, norm = _rollout_setup(dev, "cartpole", 1024, 32, seed=2)
    cfg.target_kl = 0.01
    state = TrainState(network=net, opt_state=AdamState.create(net), carry=carry, obs_norm=norm)
    step = make_train_step(env, cfg)
    state, _, _ = step(state, 0.003, 0.01, rng)  # the captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics, _ = step(state, 0.003, 0.01, rng)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert float(metrics["num_minibatch_updates"]) >= 1


def temperature_inputs(dev, rows, A, seed, ties=True):
    """Logits, a mask with at least one legal action a row, per-row
    temperatures mixed from 0, 0.4, 1 and 1e-3, and uniforms; a third of
    the rows hold exact ties between two legal columns."""
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn(rows, A, generator=g, device=dev) * 2
    mask = (torch.rand(rows, A, generator=g, device=dev) > 0.3).float()
    mask[:, A - 1] = 1.0
    if ties and A > 1:
        tied = torch.rand(rows, generator=g, device=dev) < 0.33
        cols = torch.randperm(A, generator=g, device=dev)[:2]
        logits[tied.nonzero()[:, 0][:, None], cols[None, :]] = 9.0
        mask[tied.nonzero()[:, 0][:, None], cols[None, :]] = 1.0
    choice = torch.tensor([0.0, 0.4, 1.0, 1e-3], device=dev)
    temps = choice[torch.randint(0, 4, (rows,), generator=g, device=dev)]
    uni = torch.rand(rows, A, generator=g, device=dev).clamp_min(TINY)
    return logits, mask, temps, uni


@pytest.mark.parametrize("rows, A", [(1, 7), (64, 7), (64, 33), (64, 49), (1024, 49), (5, 2),
                                     (33, 8), (65, 9), (3, 64), (1, 1)])
def test_temperature_sample_kernel_equals_plain(dev, rows, A):
    """K14's actions are the plain version's at every row, per-row
    temperatures, with and without the mask, and at one temperature for
    all rows (0 and 0.7)."""
    logits, mask, temps, uni = temperature_inputs(dev, rows, A, rows * 100 + A)
    for m in (mask, None):
        for t in (temps, 0.0, 0.7):
            got = sample_with_temperature(logits, m, t, uni)
            torch.cuda.synchronize()
            want = sample_with_temperature_plain(logits, m, t, uni)
            assert got.dtype == torch.int32 and torch.equal(got, want)
            if m is not None:
                assert bool(torch.all(torch.gather(m, 1, got.long()[:, None]) > 0))


def test_temperature_sample_kernel_breaks_greedy_ties_to_the_last_index(dev):
    """Every column tied: greedy rows take the last legal column, across
    all of a row's lanes."""
    for A in (2, 7, 33, 49, 64):
        logits = torch.zeros(96, A, device=dev)
        mask = torch.ones(96, A, device=dev)
        mask[1::2, A - 1] = 0.0  # odd rows: the last legal is A - 2
        got = sample_with_temperature(logits, mask, 0.0, torch.full((96, A), 0.5, device=dev))
        want = torch.where(torch.arange(96, device=dev) % 2 == 1, A - 2, A - 1)
        assert torch.equal(got.long(), want) or A == 1


def test_temperature_sample_kernel_refuses_what_it_cannot_take(dev):
    logits, mask, temps, uni = temperature_inputs(dev, 8, 65, 0, ties=False)
    with pytest.raises(ValueError, match="at most 64"):
        sample_with_temperature(logits, mask, temps, uni)
    logits, mask, temps, uni = temperature_inputs(dev, 8, 7, 0)
    with pytest.raises(ValueError, match="temperature"):
        sample_with_temperature(logits, mask, temps[:4], uni)
    with pytest.raises(ValueError, match="contiguous"):
        sample_with_temperature(logits.t().contiguous().t(), mask, temps, uni)


def popart_case(dev, N, count, H, seed, valid_share=1.0):
    """Raw returns [N], valid [N], a state of ``count`` samples and a value
    head [H, 1] + [1], on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(N, generator=g, device=dev) * 30 + 7
    w = (torch.rand(N, generator=g, device=dev) < valid_share).float()
    state = PopArtState.create(dev)
    state.mean.fill_(2.5 if count else 0.0)
    state.m2.fill_(90.0 * count)
    state.count.fill_(float(count))
    kernel = torch.randn(H, 1, generator=g, device=dev) * 0.1
    bias = torch.randn(1, generator=g, device=dev)
    return x, w, state, kernel, bias


def popart_copy(state, kernel, bias):
    s = PopArtState(mean=state.mean.clone(), m2=state.m2.clone(), count=state.count.clone(),
                    scratch=state.scratch)
    return s, kernel.clone(), bias.clone()


@pytest.mark.parametrize("N,count,H,share", [(524288, 0, 64, 1.0), (524288, 4096, 512, 0.75),
                                             (524288, 1, 64, 1.0), (1, 1, 64, 1.0),
                                             (1, 0, 64, 1.0), (2, 0, 512, 1.0),
                                             (1000, 7, 3, 0.5), (8_000_001, 300, 512, 0.9),
                                             (4096, 9, 64, 0.0)])
def test_popart_update_kernel_matches_plain(dev, N, count, H, share):
    """K15 against its plain version: the merged stats to f64 rounding of
    the batch sums (rtol 1e-6), the head as the plain rescale of those
    stats; the count gate (0, 1 and 2 samples, an empty mask); more than
    the resident grid's registers hold (8,000,001)."""
    x, w, state, kernel, bias = popart_case(dev, N, count, H, N + count)
    ps, pk, pb = popart_copy(state, kernel, bias)
    before = popart_update_rescale.launches
    popart_update_rescale(state, x, w, kernel, bias)
    torch.cuda.synchronize()
    assert popart_update_rescale.launches == before + 1
    popart_update_rescale_plain(ps, x, w, pk, pb)
    for f in ("mean", "m2", "count"):
        torch.testing.assert_close(getattr(state, f), getattr(ps, f), rtol=1e-6, atol=1e-6)
    assert float(state.count) == float(ps.count)
    torch.testing.assert_close(kernel, pk, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(bias, pb, rtol=1e-6, atol=1e-6)
    if float(state.count) < 2:
        assert torch.equal(kernel, popart_case(dev, N, count, H, N + count)[3])


def test_popart_update_kernel_gives_the_same_bits_twice_and_on_graph_replays(dev):
    x, w, state, kernel, bias = popart_case(dev, 524288, 1000, 512, 3, 0.8)
    start = popart_copy(state, kernel, bias)
    outs = []
    for _ in range(2):
        s, k, b = popart_copy(*start)
        popart_update_rescale(s, x, w, k, b)
        outs.append(torch.cat([s.mean[None], s.m2[None], s.count[None], k[:, 0], b]))
    s, k, b = popart_copy(*start)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        popart_update_rescale(s, x, w, k, b)
    s0, k0, b0 = start
    for _ in range(2):
        for dst, src in zip((s.mean, s.m2, s.count, k, b), (s0.mean, s0.m2, s0.count, k0, b0)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        outs.append(torch.cat([s.mean[None], s.m2[None], s.count[None], k[:, 0], b]))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.parametrize("n,count", [(4096, 0), (4096, 1), (4096, 2), (4096, 5000), (7, 3)])
def test_popart_denormalize_kernel_is_the_plain_version_bit_for_bit(dev, n, count):
    """K16, two roundings as the plain version: the same bits, into a
    slice of a larger buffer as the rollout's values."""
    x, _, state, _, _ = popart_case(dev, n, count, 1, n + 17 * count)
    out = torch.zeros(3, n, device=dev)
    before = popart_denormalize.launches
    popart_denormalize(state, x, out=out[1])
    torch.cuda.synchronize()
    assert popart_denormalize.launches == before + 1
    assert torch.equal(out[1], popart_denormalize_plain(state, x))
    assert torch.equal(out[0], torch.zeros(n, device=dev))
    if count < 2:
        assert torch.equal(out[1], x)


@pytest.mark.parametrize("M,A,clip_value", [(65536, 7, True), (65536, 49, True),
                                            (65536, 49, False), (1000, 2, True)])
@pytest.mark.parametrize("count", [1, 5000])
def test_ppo_loss_kernel_with_popart_and_the_controller_matches_plain(dev, M, A, clip_value,
                                                                       count):
    """K8 with PopArt's stats (the gate closed at count 1) and the
    controller stepping on this minibatch: the loss, metrics and gradients
    to K8's tolerances, the stepped coefficient and the recorded entropy
    to the metric's."""
    g = torch.Generator(device=dev).manual_seed(M + A + count)
    logits, values, mb = loss_batch(g, dev, M, A)
    mb["returns"] = mb["returns"] * 40 + 9
    mb["old_values"] = mb["old_values"] * 40 + 9
    _, _, popart, _, _ = popart_case(dev, 8, count, 1, 5)
    cfg = PPOUpdateConfig(clip_epsilon=0.1, clip_value=clip_value, ent_delta=0.004)
    outs = []
    for fn in (ppo_loss_forward, ppo_loss_plain):
        ctrl = AdaptiveEntropyState.create(0.02, dev)
        adaptive_entropy_record(ctrl, torch.tensor(0.3, device=dev))
        book = LossBook.create(dev)
        before = ppo_loss.launches
        res = fn(logits, values, mb, torch.full((), 0.9, device=dev), cfg, book, False, popart,
                 ctrl, True)
        torch.cuda.synchronize()
        assert ppo_loss.launches == before + (fn is ppo_loss_forward)
        outs.append((res, ctrl, book))
    (k, kc, kb), (p, pc, pb) = outs
    torch.testing.assert_close(k[0], p[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(k[1], p[1], rtol=1e-5, atol=1e-6)
    for a, b in zip(k[2:], p[2:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * float(b.abs().max()))
    assert float(kc.coef) == float(pc.coef) == float(torch.tensor(0.024, dtype=torch.float32))
    assert float(kc.last_entropy) == float(kb.sums[2] / kb.count)
    torch.testing.assert_close(kc.last_entropy, pc.last_entropy, rtol=1e-5, atol=1e-6)
    assert bool(kc.has_entropy)


def test_ppo_loss_kernel_with_the_controller_on_later_minibatches_reads_its_coefficient(dev):
    """Not the update's first minibatch: the coefficient is the state's
    as it stands, and the record takes the book's running mean."""
    g = torch.Generator(device=dev).manual_seed(11)
    logits, values, mb = loss_batch(g, dev, 4096, 33)
    cfg = PPOUpdateConfig()
    ctrl = AdaptiveEntropyState.create(0.037, dev)
    book = LossBook.create(dev)
    k = ppo_loss_forward(logits, values, mb, torch.full((), 5.0, device=dev), cfg, book, False,
                         None, ctrl, False)
    ref = ppo_loss_forward(logits, values, mb, torch.full((), 0.037, device=dev), cfg,
                           LossBook.create(dev))
    torch.cuda.synchronize()
    assert torch.equal(k[0], ref[0]) and torch.equal(k[2], ref[2])
    assert float(ctrl.coef) == float(torch.tensor(0.037))
    assert float(ctrl.last_entropy) == float(book.sums[2] / book.count)
