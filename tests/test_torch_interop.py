"""The Rust reference's Burn NamedMpk checkpoints imported by the port
(``burn_ppo_torch/interop.py``) against the JAX package's importer
(``burn_ppo_tpu/interop.py``) on the fixtures of ``tests/test_interop.py``
(MLP with an obs normaliser, CTDE, CNN with the NCHW flatten), and
``eval`` / ``tournament`` through ``cli.main(..., device="cpu")`` on a
Burn directory written from a gauntlet checkpoint against its ``.npz``
original. Tolerances: parameters and normaliser bit for bit (the import
only moves f32 bytes), forward outputs 1e-6 (two frameworks' matmuls)."""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import tests.test_interop as ti  # noqa: E402
from burn_ppo_torch import cli  # noqa: E402
from burn_ppo_torch import interop  # noqa: E402
from burn_ppo_torch.checkpoint import (  # noqa: E402
    ReferenceImportError,
    is_reference_checkpoint,
    load_model,
    load_obs_normalizer,
)
from burn_ppo_torch.convert import params_to_jax, tree_leaves  # noqa: E402
from burn_ppo_tpu import interop as jinterop  # noqa: E402
from burn_ppo_tpu.models.network import ActorCriticNetwork  # noqa: E402

GAUNTLET = Path(__file__).resolve().parent.parent / "gauntlet"
C4 = GAUNTLET / "connect_four"


def mlp_fixture(tmp_path):
    net = ActorCriticNetwork(network_type="mlp", obs_dim=5, action_count=3, hidden_size=8,
                             num_hidden=2, activation="tanh")
    params = jax.device_get(net.init(jax.random.PRNGKey(0)))
    record = {"layers": [ti.linear_rec(x, f"l{i}") for i, x in enumerate(params["layers"])],
              "policy_head": ti.linear_rec(params["policy_head"], "ph"),
              "value_head": ti.linear_rec(params["value_head"], "vh")}
    meta = {"step": 100, "obs_dim": 5, "action_count": 3, "num_players": 1, "hidden_size": 8,
            "num_hidden": 2, "activation": "tanh", "network_type": "mlp",
            "env_name": "cartpole", "avg_return": 1.0, "rng_seed": 0}
    norm = {"mean": [0.1, -0.2, 0.3, 0.0, 1.5], "var": [2.0, 0.5, 1.0, 3.0, 0.25],
            "count": 50.0, "clip": 10.0}
    ti._write_reference_ckpt(tmp_path, "Mlp", record, meta, norm)
    return net, params, 5, None


def ctde_fixture(tmp_path):
    net = ActorCriticNetwork(network_type="ctde", obs_dim=6, action_count=4, hidden_size=8,
                             num_hidden=1, activation="tanh", privileged_obs_dim=10,
                             critic_hidden_size=12, critic_num_hidden=2)
    params = jax.device_get(net.init(jax.random.PRNGKey(1)))
    record = {
        "actor_layers": [ti.linear_rec(x, f"a{i}")
                         for i, x in enumerate(params["actor_layers"])],
        "policy_head": ti.linear_rec(params["policy_head"], "ph"),
        "critic_layers": [ti.linear_rec(x, f"c{i}")
                          for i, x in enumerate(params["critic_layers"])],
        "value_head": ti.linear_rec(params["value_head"], "vh"),
    }
    meta = {"step": 5, "obs_dim": 6, "action_count": 4, "num_players": 4, "hidden_size": 8,
            "num_hidden": 1, "activation": "tanh", "network_type": "ctde",
            "privileged_obs_dim": 10, "critic_hidden_size": 12, "critic_num_hidden": 2,
            "env_name": "liars_dice", "avg_return": 0.0, "rng_seed": 0}
    ti._write_reference_ckpt(tmp_path, "Ctde", record, meta)
    return net, params, 6, 10


def cnn_fixture(tmp_path):
    h, w, c = 6, 7, 2
    net = ActorCriticNetwork(network_type="cnn", obs_dim=h * w * c + 2, action_count=7,
                             hidden_size=8, num_hidden=1, activation="tanh", obs_shape=(h, w, c),
                             num_conv_layers=2, conv_channels=(4, 4), kernel_size=3,
                             cnn_fc_hidden_size=16, cnn_num_fc_layers=1)
    params = jax.device_get(net.init(jax.random.PRNGKey(2)))
    fc0 = dict(params["fc_layers"][0])
    fc0["kernel"] = ti.nhwc_to_nchw_rows(np.asarray(fc0["kernel"]), h, w, 4)
    record = {"conv_layers": [ti.conv_rec(x, f"cv{i}")
                              for i, x in enumerate(params["conv_layers"])],
              "fc_layers": [ti.linear_rec(fc0, "fc0")],
              "policy_head": ti.linear_rec(params["policy_head"], "ph"),
              "value_head": ti.linear_rec(params["value_head"], "vh")}
    meta = {"step": 5, "obs_dim": h * w * c + 2, "action_count": 7, "num_players": 2,
            "hidden_size": 8, "num_hidden": 1, "activation": "tanh", "network_type": "cnn",
            "obs_shape": [h, w, c], "num_conv_layers": 2, "conv_channels": [4, 4],
            "kernel_size": 3, "cnn_fc_hidden_size": 16, "cnn_num_fc_layers": 1,
            "env_name": "connect_four", "avg_return": 0.0, "rng_seed": 0}
    ti._write_reference_ckpt(tmp_path, "Cnn", record, meta)
    return net, params, h * w * c + 2, None


FIXTURES = {"mlp": mlp_fixture, "ctde": ctde_fixture, "cnn": cnn_fixture}


@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_import_equals_jax_params_obs_norm_and_forward(tmp_path, kind):
    net, params, obs_dim, priv_dim = FIXTURES[kind](tmp_path)
    jnet, jparams, jnorm, jmeta = jinterop.load_reference_checkpoint(tmp_path)
    network, norm, meta = interop.load_reference_checkpoint(tmp_path)
    assert meta == jmeta and network.network_type == kind
    got = tree_leaves(params_to_jax(network.state_dict()))
    want = tree_leaves(jax.device_get(jparams))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    if jnorm is None:
        assert norm is None
    else:
        for a, b in ((norm.mean, jnorm.mean), (norm.m2, jnorm.m2), (norm.count, jnorm.count)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(7)
    obs = rng.normal(size=(5, obs_dim)).astype(np.float32)
    with torch.no_grad():
        if priv_dim is None:
            logits, values = network(torch.from_numpy(obs))
            jl, jv = jnet.forward(jparams, jnp.asarray(obs))
        else:
            priv = rng.normal(size=(5, priv_dim)).astype(np.float32)
            logits, values = network(torch.from_numpy(obs), torch.from_numpy(priv))
            jl = jnet.forward_actor(jparams, jnp.asarray(obs))
            jv = jnet.forward_critic(jparams, jnp.asarray(priv), jnp.asarray(obs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-6, rtol=0)
    np.testing.assert_allclose(values.numpy(), np.asarray(jv).reshape(-1), atol=1e-6, rtol=0)
    # the loaders route the directory as JAX's CheckpointManager does
    assert is_reference_checkpoint(tmp_path)
    net2, meta2 = load_model(tmp_path)
    for a, b in zip(net2.state_dict().values(), network.state_dict().values()):
        assert torch.equal(a, b)
    assert meta2 == meta
    norm2 = load_obs_normalizer(tmp_path)
    assert (norm2 is None) == (norm is None)


@pytest.mark.parametrize("change, error, match", [
    ({"hidden_size": 16}, ValueError, "shape"),  # the record was built with 8
    ({"split_networks": True}, ValueError, "structure"),  # no critic layers in the record
])
def test_mismatched_record_is_refused_as_jax_refuses_it(tmp_path, change, error, match):
    mlp_fixture(tmp_path)
    meta = json.loads((tmp_path / "metadata.json").read_text())
    (tmp_path / "metadata.json").write_text(json.dumps({**meta, **change}))
    with pytest.raises(error, match=match):
        jinterop.load_reference_checkpoint(tmp_path)
    with pytest.raises(error, match=match):
        interop.load_reference_checkpoint(tmp_path)
    with pytest.raises(ReferenceImportError, match=match):
        load_model(tmp_path)


def test_missing_tensor_is_refused_as_jax_refuses_it(tmp_path):
    net, params, _, _ = mlp_fixture(tmp_path)
    record = {"layers": [ti.linear_rec(x, f"l{i}") for i, x in enumerate(params["layers"])],
              "policy_head": ti.linear_rec(params["policy_head"], "ph")}
    (tmp_path / "model.mpk").write_bytes(ti.enc({"Mlp": record}))
    for load in (jinterop.load_reference_checkpoint, interop.load_reference_checkpoint):
        with pytest.raises(KeyError, match="value_head"):
            load(tmp_path)


def test_decoder_and_walker_equal_jax():
    cases = [None, True, False, 0, 127, -32, 1_000_000, -1_000_000, 3.5, "", "x" * 100,
             b"\x00\xff", list(range(40)), {"a": 1, "b": [2, {"c": None}]}]
    for obj in cases:
        assert interop.msgpack_decode(ti.enc(obj)) == jinterop.msgpack_decode(ti.enc(obj)) == obj
    rec = ti.msgpack_decode(ti.enc({"Mlp": {"layers": [ti.linear_rec(
        {"kernel": np.arange(6.0).reshape(2, 3), "bias": np.ones(3)}, "0")]}}))
    got, want = interop.collect_tensors(rec), jinterop.collect_tensors(rec)
    assert sorted(got) == sorted(want) == [("layers", 0, "bias"), ("layers", 0, "weight")]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# A Burn directory of a gauntlet checkpoint, through eval and tournament
# ---------------------------------------------------------------------------
def write_burn_dir(src: Path, dst: Path) -> Path:
    """``src``'s MLP weights as a Burn record (``model.mpk``), its
    ``metadata.json``, and its obs normaliser as ``normalizer.json`` (M2
    in ``var``); no ``model.npz``."""
    network, meta = load_model(src)
    assert meta["network_type"] == "mlp" and not meta.get("split_networks")
    tree = params_to_jax(network.state_dict())
    record = {"layers": [ti.linear_rec(x, f"l{i}") for i, x in enumerate(tree["layers"])],
              "policy_head": ti.linear_rec(tree["policy_head"], "ph"),
              "value_head": ti.linear_rec(tree["value_head"], "vh")}
    norm = load_obs_normalizer(src)
    dst.mkdir(parents=True)
    ti._write_reference_ckpt(dst, "Mlp", record, meta, None if norm is None else {
        "mean": norm.mean.tolist(), "var": norm.m2.tolist(), "count": float(norm.count),
        "clip": 10.0})
    return dst


def test_eval_on_a_burn_directory_plays_the_npz_games(tmp_path, capsys):
    burn = write_burn_dir(C4 / "r4", tmp_path / "burn" / "r4")
    assert is_reference_checkpoint(burn) and not is_reference_checkpoint(C4 / "r4")
    texts = []
    for ckpt in (burn, C4 / "r4"):
        assert cli.main(["eval", "-c", str(ckpt), "--random", "-n", "12", "--num-envs", "4",
                         "--seed", "5"], device="cpu") == 0
        # the table's rows, the checkpoint's path read as one name
        texts.append([["r4" if w == str(ckpt) else w for w in ln.split()]
                      for ln in capsys.readouterr().out.splitlines()])
    assert texts[0] == texts[1] and ["r4", "12", "100.0%", "1.00", "1.000"] in texts[0]


def test_tournament_on_a_burn_directory_plays_the_npz_games(tmp_path):
    burn = write_burn_dir(C4 / "r4", tmp_path / "burn" / "r4")
    runs = []
    for first in (burn, C4 / "r4"):
        out = tmp_path / f"{len(runs)}.json"
        assert cli.main(["tournament", str(first), str(C4 / "r4_mid"), "--random", "-n", "4",
                         "--num-envs", "4", "--seed", "2", "-o", str(out)], device="cpu") == 0
        runs.append(json.loads(out.read_text()))
    burn_run, npz_run = runs
    def rows(run):
        return [{k: r[k] for k in r if k not in ("source", "name")} for r in run["rankings"]]

    assert rows(burn_run) == rows(npz_run)
    assert [r["name"].split("/")[-1] for r in burn_run["rankings"]] == [
        r["name"] for r in npz_run["rankings"]]
    def pods(run):
        return [{**p, "contestants": [c.split("/")[-1] for c in p["contestants"]]}
                for p in run["pods"]]

    assert pods(burn_run) == pods(npz_run) and burn_run["total_games"] == 12


def test_reference_directory_copy_without_normalizer_loads_none(tmp_path):
    """``normalizer.json``'s presence is the reference's normalize_obs flag:
    without it the import has no obs normaliser, whatever the metadata
    says (checkpoint.rs:428-439)."""
    burn = write_burn_dir(C4 / "r4", tmp_path / "burn" / "r4")
    bare = tmp_path / "bare"
    shutil.copytree(burn, bare)
    (bare / "normalizer.json").unlink()
    assert load_obs_normalizer(bare) is None
    assert jinterop.load_reference_obs_norm(bare) is None
    assert load_obs_normalizer(burn) is not None
