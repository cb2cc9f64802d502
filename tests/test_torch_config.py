"""The port's own config, schedule and command-line parser against the JAX
package's: every shipped TOML loads to the same fields, bad values give
the same validation errors, the same argv gives the same overrides, and
schedules give the same values."""

import dataclasses
from pathlib import Path

import pytest

from burn_ppo_tpu import cli as jax_cli
from burn_ppo_tpu.config import Config as JaxConfig
from burn_ppo_tpu.config import generate_run_name as jax_run_name
from burn_ppo_tpu.schedule import Schedule as JaxSchedule
from burn_ppo_torch import cli
from burn_ppo_torch.config import Config, generate_run_name
from burn_ppo_torch.schedule import Schedule

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs").glob("*.toml"))


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _comparable(v):
    """Schedules and player-count modes by their TOML value."""
    return v.to_toml_value() if hasattr(v, "to_toml_value") else v


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_every_config_loads_field_for_field_as_in_jax(path):
    mine, ref = Config.load(path), JaxConfig.load(path)
    a, b = _fields(mine), _fields(ref)
    assert list(a) == list(b)
    for k in a:
        assert _comparable(a[k]) == _comparable(b[k]), k
    assert mine.to_dict() == ref.to_dict()
    mine.validate()
    ref.validate()
    assert mine.resolve_num_envs(1) == ref.resolve_num_envs(1)
    for P in (1, 2, 4):
        assert mine.effective_normalize_returns(P) == ref.effective_normalize_returns(P)


def test_saved_toml_is_the_same_text(tmp_path):
    mine = Config.load("configs/connect_four.toml").apply_overrides({"num_envs": 64})
    ref = JaxConfig.load("configs/connect_four.toml").apply_overrides({"num_envs": 64})
    mine.save_toml(tmp_path / "a.toml")
    ref.save_toml(tmp_path / "b.toml")
    assert (tmp_path / "a.toml").read_text() == (tmp_path / "b.toml").read_text()
    assert Config.load(tmp_path / "b.toml").to_dict() == mine.to_dict()


BAD = [
    {"num_steps": 0},
    {"gamma": 0.0},
    {"gae_lambda": 1.5},
    {"clip_epsilon": 1.0},
    {"activation": "gelu"},
    {"network_type": "rnn"},
    {"num_epochs": 0},
    {"network_type": "cnn", "num_conv_layers": 0},
    {"opponent_pool_fraction": 1.5},
    {"pool_rotation_interval": 0},
    {"pool_rotation_interval": 3},
    {"learning_rate": -1.0},
    {"entropy_coef": -0.1},
    {"env": "chess"},
    {"max_active_opponents": 0},
    {"max_active_opponents": 200},
    {"max_training_time": "ten minutes"},
    {"compute_dtype": "float16"},
    {"runtime_guards": "maybe"},
    {"adaptive_entropy": 1.0, "adaptive_entropy_max_coef": 0.0},
    {"gamma": 2.0, "env": "chess", "num_steps": -1},
]


def _supported(line: str) -> set:
    return set(line.split("Supported: ", 1)[1].split(", "))


@pytest.mark.parametrize("bad", BAD, ids=lambda d: "-".join(d))
def test_validation_errors_match_jax(bad):
    """The same messages in the same order. Other tests register extra envs
    in the JAX registry at run time, so the unknown-env line lists the
    port's four and a subset of JAX's."""
    base = {"env": "connect_four", **bad}
    with pytest.raises(ValueError) as mine:
        Config.from_dict(base).validate()
    with pytest.raises(ValueError) as ref:
        JaxConfig.from_dict(base).validate()
    a, b = str(mine.value).splitlines(), str(ref.value).splitlines()
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if "Supported: " in x:
            assert x.split("Supported: ")[0] == y.split("Supported: ")[0]
            assert _supported(x) == {"cartpole", "connect_four", "liars_dice", "skull"}
            assert _supported(x) <= _supported(y)
        else:
            assert x == y


def test_unknown_keys_and_missing_env_fail_alike(tmp_path):
    for cls in (Config, JaxConfig):
        with pytest.raises(ValueError, match="Unknown config keys"):
            cls.from_dict({"env": "cartpole", "num_envz": 4})
    (tmp_path / "noenv.toml").write_text("num_envs = 4\n")
    for cls in (Config, JaxConfig):
        with pytest.raises(ValueError, match="must specify 'env'"):
            cls.load(tmp_path / "noenv.toml")
    with pytest.raises(ValueError) as mine:
        Config.load("configs/cartpole.toml").apply_overrides({"gamma": 0.9}, resume=True)
    with pytest.raises(ValueError) as ref:
        JaxConfig.load("configs/cartpole.toml").apply_overrides({"gamma": 0.9}, resume=True)
    assert str(mine.value) == str(ref.value)


ARGV = [
    [],
    ["--config", "configs/connect_four.toml"],
    ["--num-envs", "4096", "--normalize-obs", "--no-clip-value"],
    ["--learning-rate", "0.001@0,0.0001@30M", "--entropy-coef", "0.02"],
    ["--opponent-pool-fraction", "0.25", "--max-active-opponents", "8",
     "--pool-rotation-interval", "2", "--debug-opponents"],
    ["--network-type", "cnn", "--activation", "relu", "--num-conv-layers", "3",
     "--kernel-size", "5", "--cnn-fc-hidden-size", "64"],
    ["--players", "3", "--seed", "7", "--max-training-time", "5m", "--target-kl", "0.02"],
    ["--shuffle-block-rows", "1", "--mesh-data", "2", "--compute-dtype", "bfloat16"],
]


@pytest.mark.parametrize("argv", ARGV, ids=lambda a: " ".join(a[:2]) or "none")
def test_overrides_match_jax(argv):
    mine = cli.build_parser().parse_args(["train", *argv])
    ref = jax_cli.build_parser().parse_args(["train", *argv])
    assert cli.collect_overrides(mine) == jax_cli.collect_overrides(ref)
    assert vars(mine) == vars(ref)
    cfg = Config.load(mine.config).apply_overrides(cli.collect_overrides(mine))
    jcfg = JaxConfig.load(ref.config).apply_overrides(jax_cli.collect_overrides(ref))
    assert cfg.to_dict() == jcfg.to_dict()


def test_every_train_flag_is_the_jax_flag():
    def flags(parser):
        sub = next(a for a in parser._actions if a.dest == "command")
        return sorted(o for a in sub.choices["train"]._actions for o in a.option_strings)

    assert flags(cli.build_parser()) == flags(jax_cli.build_parser())
    assert cli.TRAIN_OVERRIDE_KEYS == jax_cli.TRAIN_OVERRIDE_KEYS


@pytest.mark.parametrize("spec", [0.0003, "0.001@0,0.0001@30M", [[1.0, 0], [0.5, 1000], [0.1, 5000]],
                                  "2e-4@0,1e-4@1.5M,5e-5@3M"])
def test_schedules_match_jax(spec):
    mine = Schedule.parse(spec)
    ref = JaxSchedule.parse(spec)
    for step in (0, 1, 500, 999, 1000, 2500, 5000, 10**6, 1_500_000, 2_999_999, 3 * 10**7, 10**9):
        assert mine.get(step) == ref.get(step), step
    assert mine.to_toml_value() == ref.to_toml_value()
    assert mine.initial_value() == ref.initial_value()
    assert str(mine) == str(ref)
    if isinstance(spec, str):
        assert Schedule.parse_cli(spec).to_toml_value() == JaxSchedule.parse_cli(spec).to_toml_value()


def test_run_names_match_jax(tmp_path):
    for name in ("connect_four_001", "connect_four_003", "cartpole_002", "other"):
        (tmp_path / name).mkdir()
    for env, parent in (("connect_four", None), ("cartpole", None), ("skull", "run_x")):
        assert generate_run_name(tmp_path, env, parent) == jax_run_name(tmp_path, env, parent)
