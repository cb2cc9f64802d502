"""K7's packed towers (``burn_ppo_torch/ppo/opponent_pack.py``) on the CPU:
every tower a pool path runs, in f32 and bf16, packed as the bf16 tower
and the feature front hold them in shared memory.

* packing then unpacking gives the stack's weights back bit for bit;
* each packed element sits where ``mma.sync``'s B fragment puts it (PTX's
  fragment layouts of m16n8k16 bf16 and m16n8k8 tf32, written out here
  element by element);
* the plain tower run from the packed layers equals
  ``opponent_actor_forward_plain`` on the stack bit for bit;
* the feature front's first layer, permuted into the conv output's NCHW
  order, on NCHW-flattened conv features, against JAX's NHWC formulation
  (``_cnn_features`` and the policy head on the same weights, through
  numpy), f32 at ``tests/test_torch_cnn_pool.py``'s rtol 1e-5 / atol 1e-5;
* a rotation's ``copy_into`` into the rollout runner's static stack
  carries the packed layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burn_ppo_tpu.models.network import ActorCriticNetwork as JaxNetwork
from burn_ppo_torch.convert import params_from_jax
from burn_ppo_torch.models.network import ActorCriticNetwork
from burn_ppo_torch.ppo.normalization import ObsNormState
from burn_ppo_torch.ppo.opponent_pack import (
    k_block,
    nchw_rows,
    pack_layer,
    pack_tower,
    unpack_layer,
    unpack_tower,
)
from burn_ppo_torch.ppo.pool_rollout import (
    OpponentStack,
    actor_params,
    opponent_actor_forward_plain,
    opponent_cnn_front_plain,
    opponent_features_forward_plain,
)
from burn_ppo_torch.ppo.rollout_graph import _clone, copy_into, state_leaves

torch.set_num_threads(1)

F32_RTOL, F32_ATOL = 1e-5, 1e-5
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# Every tower a pool path runs: (input width, hidden width, hidden layers,
# head). The CNN's is its FC tower behind the convs: 6 x 7 x 8 conv
# features and Connect Four's two obs columns past the spatial slice.
TOWERS = {
    "connect_four_mlp512x2": (86, 512, 2, 7),
    "skull_ctde256x3": (135, 256, 3, 33),
    "liars_dice_ctde256x2": (270, 256, 2, 49),
    "liars_dice_mlp512x3": (270, 512, 3, 49),
    "connect_four_cnn_fc32": (338, 32, 1, 7),
}
SHAPE, D, A = (6, 7, 2), 86, 7


def _stack(tower: str, dtype: torch.dtype, K: int = 3, seed: int = 0,
           normed: bool = True) -> OpponentStack:
    """K random towers of ``tower``'s widths (fan-in scaled, numpy-seeded),
    their weights in ``dtype``, and obs normalisers (slot 0 at count 1,
    the identity)."""
    n_in, hidden, depth, head = TOWERS[tower]
    rng = np.random.default_rng(seed)
    sizes = [n_in] + [hidden] * depth + [head]
    weights = [torch.from_numpy((rng.normal(size=(K, i, o)) / i ** 0.5).astype(np.float32))
               .to(dtype) for i, o in zip(sizes, sizes[1:])]
    biases = [torch.from_numpy((rng.normal(size=(K, o)) * 0.1).astype(np.float32))
              for o in sizes[1:]]
    norm = None
    if normed:
        norm = ObsNormState(mean=torch.from_numpy(rng.normal(size=(K, n_in)).astype(np.float32)),
                            m2=torch.from_numpy((rng.random((K, n_in)) * 50 + 1)
                                                .astype(np.float32)),
                            count=torch.tensor([1.0] + [300.0] * (K - 1)))
    return OpponentStack(weights=weights, biases=biases, activation="relu", norm=norm)


def _jax_cnns(K: int, seed: int):
    """K JAX-initialised Connect Four CNNs (convs 2 -> 8 -> 8, FC 32, head
    7) with random biases, as numpy trees, and the port's networks loaded
    from them."""
    jnet = JaxNetwork(network_type="cnn", obs_dim=D, action_count=A, obs_shape=SHAPE,
                      activation="relu")
    rng = np.random.default_rng(seed)
    jps, nets = [], []
    for k in range(K):
        p = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(seed + k)))
        p = jax.tree_util.tree_map(
            lambda x: (x + (rng.normal(size=x.shape) * 0.1 if x.ndim == 1 else 0))
            .astype(np.float32), p)
        net = ActorCriticNetwork(D, A, network_type="cnn", obs_shape=SHAPE, activation="relu",
                                 generator=torch.Generator().manual_seed(k))
        net.load_state_dict(params_from_jax(p))
        jps.append(p)
        nets.append(net)
    return jnet, jps, nets


def _cnn_stack(nets, compute_dtype=None) -> OpponentStack:
    return OpponentStack.of([actor_params(n, compute_dtype) for n in nets], None)


def _inputs(K: int, Ep: int, seed: int):
    rng = np.random.default_rng(seed)
    obs = torch.from_numpy((rng.random((Ep, D)) < 0.3).astype(np.float32) * 2.0 - 0.5)
    slot = torch.from_numpy(rng.integers(-1, K + 1, size=Ep).astype(np.int32))
    return obs, slot


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_packing_round_trips_bit_for_bit(tower, dtype):
    """Every layer packed as ``[K, kb, nt, 32, E]`` (16 bytes a lane, the
    inputs padded to a k-block, the head to 8 columns, with zeros) and
    unpacked gives the weights back bit for bit; the CNN's first layer
    also through its NCHW row order."""
    stack = _stack(tower, DTYPES[dtype])
    widths = [stack.weights[0].shape[1]] + [w.shape[2] for w in stack.weights]
    rows = nchw_rows(SHAPE, 8, widths[0]) if tower.endswith("cnn_fc32") else None
    packed = pack_tower(stack.weights, rows)
    for w, p in zip(stack.weights, packed.layers):
        K, n_in, n_out = w.shape
        KB = k_block(w.dtype)
        assert p.dtype == w.dtype and p.is_contiguous()
        assert p.shape == (K, -(-n_in // KB), -(-n_out // 8), 32, 16 // w.element_size())
        assert int(torch.count_nonzero(p)) == int(torch.count_nonzero(w))
    for w, u in zip(stack.weights, unpack_tower(packed, widths, rows)):
        assert u.dtype == w.dtype and torch.equal(u, w)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_packed_elements_sit_where_the_mma_fragments_put_them(dtype):
    """Element by element, on a 70 x 20 layer (a ragged k-block and a
    ragged tile): lane l's 16 bytes of (k-block b, tile t) are its B
    fragments of two k-steps s. PTX m16n8k16 bf16: register r of step s
    holds rows 2 (l % 4) + h + 8 r (h the half) of column l // 4; m16n8k8
    tf32: rows l % 4 + 4 r. Past the layer's rows or columns: zeros."""
    dt = DTYPES[dtype]
    w = torch.arange(1, 2 * 70 * 20 + 1, dtype=torch.float32).reshape(2, 70, 20).to(dt)
    p = pack_layer(w)
    steps, k_step = (16, 16) if dt == torch.bfloat16 else (8, 8)
    regs = 2
    halves = 2 if dt == torch.bfloat16 else 1
    for slot in range(2):
        for b in range(p.shape[1]):
            for t in range(p.shape[2]):
                for lane in range(32):
                    grp, tig = lane // 4, lane % 4
                    e = 0
                    for s in range(2):
                        for r in range(regs):
                            for h in range(halves):
                                if dt == torch.bfloat16:
                                    row = b * 32 + s * steps + 2 * tig + h + 8 * r
                                else:
                                    row = b * 16 + s * k_step + tig + 4 * r
                                col = t * 8 + grp
                                want = w[slot, row, col] if row < 70 and col < 20 else 0
                                assert p[slot, b, t, lane, e] == want, (b, t, lane, e)
                                e += 1


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tower", sorted(set(TOWERS) - {"connect_four_cnn_fc32"}))
def test_plain_tower_from_the_packed_layers_equals_the_stacks(tower, dtype):
    """The raw-obs towers: the plain K7 on the tower unpacked from the
    stack's packed layers (a bf16 stack holds them; an f32 stack's raw-obs
    tower, K7's f32 tower, reads its weights, and packs here) equals it on
    the stack, bit for bit, out-of-range slots zeros."""
    stack = _stack(tower, DTYPES[dtype], K=3, seed=len(tower))
    assert (stack.packed is not None) == (dtype == "bf16")
    packed = stack.packed or pack_tower(stack.weights)
    widths = [stack.weights[0].shape[1]] + [w.shape[2] for w in stack.weights]
    unpacked = dataclasses.replace(stack, weights=unpack_tower(packed, widths))
    rng = np.random.default_rng(len(tower))
    obs = torch.from_numpy(rng.normal(size=(37, widths[0])).astype(np.float32) * 2.0)
    slot = torch.from_numpy(rng.integers(-1, 4, size=37).astype(np.int32))
    want = opponent_actor_forward_plain(obs, slot, stack)
    assert torch.equal(opponent_actor_forward_plain(obs, slot, unpacked), want)
    assert torch.equal(want[slot < 0], torch.zeros_like(want[slot < 0]))


def _packed_features_plain(feats, obs, stack):
    """Every slot's tower as the feature front runs it: the slot's conv
    features over every row (``feats[k]``, [Ep, C', H, W]) relu'd and
    flattened in NCHW order, the obs columns past the spatial slice, and
    the packed first layer unpacked in its NCHW row order (the later
    layers unpacked), f32 products as JAX's dense takes them: [K, Ep, A]."""
    K, Ep = stack.num_slots, obs.shape[0]
    widths = [stack.weights[0].shape[1]] + [w.shape[2] for w in stack.weights]
    layers = [unpack_layer(stack.packed.layers[0], widths[0], widths[1])] + unpack_tower(
        stack.packed, widths)[1:]
    n = SHAPE[0] * SHAPE[1] * SHAPE[2]
    out = []
    for k in range(K):
        x = torch.cat([torch.relu(feats[k]).reshape(Ep, -1), obs[:, n:]], 1)
        for i, (w, b) in enumerate(zip(layers, stack.biases)):
            x = x @ w[k].float() + b[k]
            if i < len(layers) - 1:
                x = torch.relu(x)
        out.append(x)
    return torch.stack(out)


def test_nchw_first_layer_on_nchw_features_equals_jax_nhwc():
    """Connect Four's CNN (338 -> 32 -> 7 behind its convs), f32: the
    first FC layer packed in the conv output's NCHW order, applied to each
    slot's NCHW-flattened conv features (K20's plain version with every
    row under that slot, the relu at the load) and the obs columns past
    the spatial slice, against JAX's ``forward_actor`` (``_cnn_features``'
    NHWC flatten and the policy head) on the same weights, per slot; and
    the feature front's plain version (NHWC) on the same stack, each row's
    own slot's features."""
    K = 3
    jnet, jps, nets = _jax_cnns(K, seed=5)
    stack = _cnn_stack(nets)
    obs, slot = _inputs(K, Ep=40, seed=5)
    feats = [opponent_cnn_front_plain(obs, torch.full_like(slot, k), stack) for k in range(K)]
    got = _packed_features_plain(feats, obs, stack)
    for k in range(K):
        want = np.asarray(jnet.forward_actor(jps[k], jnp.asarray(obs.numpy())))
        np.testing.assert_allclose(got[k].numpy(), want, rtol=F32_RTOL, atol=F32_ATOL)
    plain = opponent_features_forward_plain(opponent_cnn_front_plain(obs, slot, stack), obs, slot,
                                            stack)
    inside = (slot >= 0) & (slot < K)
    rows = torch.arange(obs.shape[0])
    np.testing.assert_allclose(plain[inside].numpy(),
                               got[slot[inside].long(), rows[inside]].numpy(),
                               rtol=F32_RTOL, atol=F32_ATOL)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_cnn_stack_packs_its_tower_in_nchw_order(compute_dtype):
    """A CNN stack (f32, or bf16 as a bf16 run stores it) packs its FC
    tower at construction, the first layer's rows in NCHW order
    (``nchw_rows``: row j = channel j // 42 at pixel j % 42, JAX's row
    (j % 42) 8 + j // 42; the two obs columns last), and unpacks to its
    weights bit for bit."""
    _, _, nets = _jax_cnns(2, seed=9)
    stack = _cnn_stack(nets, compute_dtype)
    assert stack.cnn and stack.bf16 == (compute_dtype == "bfloat16")
    rows = nchw_rows(SHAPE, 8, 338)
    assert rows[:3].tolist() == [0, 8, 16] and rows[42] == 1 and rows[336:].tolist() == [336, 337]
    assert torch.equal(torch.sort(rows).values, torch.arange(338))
    assert torch.equal(stack.first_rows(), rows)
    first = unpack_layer(stack.packed.layers[0], 338, 32)
    assert torch.equal(first, stack.weights[0][:, rows])
    for w, u in zip(stack.weights, unpack_tower(stack.packed, [338, 32, 7], rows)):
        assert torch.equal(u, w)


@pytest.mark.parametrize("kind", ["bf16_mlp", "f32_cnn", "bf16_cnn"])
def test_a_rotations_copy_into_the_static_stack_carries_the_packed_layers(kind):
    """The rollout runner clones the first rotation's stack into its static
    one (the clone packs its own copy of the weights) and copies each later
    rotation in with ``copy_into``: the static stack's packed layers keep
    their buffers and take the new rotation's values, so a captured graph
    reads them at fixed addresses. An f32 raw-obs stack has none."""
    if kind == "bf16_mlp":
        first, second = (_stack("skull_ctde256x3", torch.bfloat16, seed=s) for s in (1, 2))
    else:
        cd = "bfloat16" if kind == "bf16_cnn" else None
        first, second = (_cnn_stack(_jax_cnns(2, seed=s)[2], cd) for s in (1, 2))
    static = _clone(first)
    assert static.packed is not None and all(
        a.data_ptr() != b.data_ptr() for a, b in zip(static.packed.layers, first.packed.layers))
    ptrs = [t.data_ptr() for t in state_leaves(static)]
    copy_into(static, second)
    assert [t.data_ptr() for t in state_leaves(static)] == ptrs
    for a, b in zip(static.packed.layers, second.packed.layers):
        assert torch.equal(a, b)
    assert len(state_leaves(static)) == len(state_leaves(second))
    assert _stack("skull_ctde256x3", torch.float32).packed is None


@pytest.mark.parametrize("kind", ["bf16_mlp", "f32_cnn"])
def test_only_the_f32_raw_obs_tower_takes_a_tiling(kind):
    """The bf16 tower and the feature front have one tiling each: a
    tiling asked of a bf16 or CNN stack is refused, on any device, before
    anything runs; the f32 raw-obs tower's tiling is its kernel's only."""
    from burn_ppo_torch.ppo.pool_rollout import opponent_actor_forward

    stack = (_stack("connect_four_mlp512x2", torch.bfloat16) if kind == "bf16_mlp"
             else _cnn_stack(_jax_cnns(2, seed=3)[2]))
    obs, slot = _inputs(stack.num_slots, 8, seed=4)
    with pytest.raises(ValueError, match="only K7's f32 tower"):
        opponent_actor_forward(obs, slot, stack, tiling=0)
    f32 = _stack("connect_four_mlp512x2", torch.float32)
    assert torch.equal(opponent_actor_forward(obs, slot.clamp(-1, 2), f32, tiling=1),
                       opponent_actor_forward_plain(obs, slot.clamp(-1, 2), f32))
