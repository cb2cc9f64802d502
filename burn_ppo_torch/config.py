"""Configuration system: TOML file + CLI overrides + frozen run snapshot.

A copy of burn_ppo_tpu/config.py with the same fields, defaults, TOML
grammar and checks, so a config means the same run in both packages;
``validate`` checks the env name against the port's own registry
(``burn_ppo_torch.envs.registered_envs``).

Feature parity with the reference's config layer (src/config.rs):
  * every training hyperparameter with the same names and defaults
    (config.rs:747-1032);
  * schedules accepted as floats or ``[[value, step], ...]`` in TOML and
    ``v@step,v@30M`` on the CLI (src/schedule.rs);
  * ``num_envs = "auto"`` (config.rs:732-740 — CPU count in the
    reference; here it rounds to a multiple of the data-mesh size);
  * resume-override policy: on ``--resume`` only ``total_steps`` and
    ``max_training_time`` may change (config.rs:1315-1410); fork allows
    any change and records lineage (config.rs:1130-1141);
  * run-name generation ``{env}_{counter:03}`` and fork children
    ``{parent}_child_{n:03}`` (config.rs:1668-1676);
  * duration strings "30s" / "5m" / "2h" (config.rs:11-40).

TPU-specific additions (absent in the single-device reference):
``compute_dtype`` and ``mesh`` (data-parallel axis size).
"""

from __future__ import annotations

import dataclasses
import os
import re
import tomllib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from burn_ppo_torch.schedule import Schedule

# Fields that may change on --resume (config.rs:1315: only these two).
RESUME_OVERRIDABLE = {"total_steps", "max_training_time"}


def _snake(s: str) -> str:
    """CamelCase -> snake_case ('UniformRandom' -> 'uniform_random')."""
    out = []
    for i, ch in enumerate(s):
        if ch.isupper() and i > 0:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


def parse_duration(s: str) -> float:
    """'30s' / '5m' / '2h' -> seconds (reference config.rs:11-40)."""
    m = re.fullmatch(r"\s*(\d+(?:\.\d+)?)\s*([smh])\s*", s)
    if not m:
        raise ValueError(f"Invalid duration '{s}': expected e.g. '30s', '5m', '2h'")
    value = float(m.group(1))
    return value * {"s": 1.0, "m": 60.0, "h": 3600.0}[m.group(2)]


@dataclass(frozen=True)
class PlayerCountMode:
    """Player-count policy for variable-player-count games (Skull).

    Reference config.rs:648-724: Fixed / UniformRandom / WeightedRandom /
    Curriculum. Encoded as a tagged value.
    """

    mode: str = "fixed"  # fixed | uniform_random | weighted_random | curriculum
    count: int = 4  # for fixed
    min_players: int = 2
    max_players: int = 6
    weights: Tuple[float, ...] = ()
    # curriculum: [[player_count, step], ...] (this framework's spelling)
    milestones: Tuple[Tuple[int, int], ...] = ()
    # curriculum: steps to ramp min -> max (reference config.rs:657-663)
    warmup_steps: int = 0

    def get_fixed_count(self) -> int:
        """Initial/fixed player count for training setup.

        Reference semantics (config.rs:675-681): Fixed -> count,
        UniformRandom | Curriculum -> min, WeightedRandom -> 4.
        A milestones-spelled curriculum (this framework's alternative to
        min/max/warmup_steps) starts at its earliest milestone's count.
        """
        if self.mode == "fixed":
            return self.count
        if self.mode == "weighted_random":
            return 4
        if self.mode == "curriculum" and self.milestones:
            return min(self.milestones, key=lambda m: m[1])[0]
        return self.min_players

    def sample(self, rng, current_step: int) -> int:
        """Sample a player count for one game (reference config.rs:683-724;
        dead code there too — training uses get_fixed_count(), but the
        semantics are part of the config surface).

        ``rng``: random.Random. Curriculum ramps min -> max linearly over
        warmup_steps (or walks milestones when that spelling is used)."""
        if self.mode == "fixed":
            return self.count
        if self.mode == "uniform_random":
            return rng.randint(self.min_players, self.max_players)
        if self.mode == "weighted_random":
            # weights[0] = P(2 players) ... weights[4] = P(6 players)
            weights = list(self.weights) or [1.0] * 5
            total = sum(weights)
            if total <= 0:
                # Reference panics on invalid weights (WeightedIndex::new).
                raise ValueError("Invalid weights for PlayerCountMode")
            r = rng.random() * total
            acc = 0.0
            for i, w in enumerate(weights):
                acc += w
                # Strict '<': first cumulative > r, so zero-weight counts
                # are unreachable (reference WeightedIndex semantics).
                if r < acc:
                    return 2 + i
            return 2 + len(weights) - 1
        # curriculum
        if self.milestones:
            ms = sorted(self.milestones, key=lambda m: m[1])
            count = ms[0][0]
            for c, s in ms:
                if current_step >= s:
                    count = c
            return count
        if self.warmup_steps <= 0 or current_step >= self.warmup_steps:
            return self.max_players
        progress = current_step / self.warmup_steps
        # Half-away-from-zero like Rust f32::round (config.rs:716-722);
        # Python's round() is banker's and would differ at exact halves.
        import math

        return self.min_players + math.floor(
            progress * (self.max_players - self.min_players) + 0.5
        )

    @staticmethod
    def parse(value: Any) -> "PlayerCountMode":
        if isinstance(value, PlayerCountMode):
            return value
        if isinstance(value, int):
            return PlayerCountMode(mode="fixed", count=value)
        if isinstance(value, str):
            return PlayerCountMode(mode="fixed", count=int(value))
        if isinstance(value, dict):
            # Accept both this framework's {"mode": "fixed"} and the
            # reference TOML's {"type": "Fixed"} spellings (config.rs:648).
            mode = value.get("mode") or _snake(value.get("type", "fixed"))
            return PlayerCountMode(
                mode=mode,
                count=int(value.get("count", 4)),
                min_players=int(value.get("min_players", value.get("min", 2))),
                max_players=int(value.get("max_players", value.get("max", 6))),
                weights=tuple(value.get("weights", ())),
                milestones=tuple(
                    (int(c), int(s)) for c, s in value.get("milestones", ())
                ),
                warmup_steps=int(value.get("warmup_steps", 0)),
            )
        raise ValueError(f"Cannot parse player_count from {value!r}")

    def to_toml_value(self):
        if self.mode == "fixed":
            return self.count
        d: Dict[str, Any] = {"mode": self.mode}
        if self.mode in ("uniform_random", "weighted_random"):
            d.update(min_players=self.min_players, max_players=self.max_players)
        if self.mode == "weighted_random":
            d["weights"] = list(self.weights)
        if self.mode == "curriculum":
            # Emit EVERY field: the run-dir config snapshot round-trips
            # through this on --resume, and dropping min/max/warmup here
            # would silently change get_fixed_count() across the resume.
            d.update(
                min_players=self.min_players,
                max_players=self.max_players,
                warmup_steps=self.warmup_steps,
            )
            if self.milestones:
                d["milestones"] = [[c, s] for c, s in self.milestones]
        return d


@dataclass
class Config:
    """Full training configuration (reference config.rs:747-924)."""

    # Environment
    env: str = "cartpole"
    num_envs: Any = "auto"  # int or "auto"
    num_steps: int = 128
    reward_shaping_coef: Schedule = field(default_factory=lambda: Schedule.constant(0.0))
    player_count: PlayerCountMode = field(default_factory=PlayerCountMode)

    # PPO hyperparameters
    learning_rate: Schedule = field(default_factory=lambda: Schedule.constant(2.5e-4))
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_epsilon: float = 0.2
    clip_value: bool = False
    entropy_coef: Schedule = field(default_factory=lambda: Schedule.constant(0.01))

    # Adaptive entropy control
    adaptive_entropy: Optional[Schedule] = None
    adaptive_entropy_min_coef: float = 0.001
    adaptive_entropy_max_coef: float = 0.1
    adaptive_entropy_delta: float = 0.001

    value_coef: float = 0.5
    max_grad_norm: float = 0.5
    target_kl: Optional[float] = None
    normalize_obs: bool = False
    # None => ON for single-player, OFF for multiplayer (main.rs:243)
    normalize_returns: Optional[bool] = None
    return_clip: float = 10.0
    normalize_values: bool = False  # PopArt

    # Training
    total_steps: int = 1_000_000
    num_epochs: int = 4
    num_minibatches: int = 4
    adam_epsilon: float = 1e-5
    max_training_time: Optional[str] = None

    # Network
    network_type: str = "mlp"
    hidden_size: int = 64
    num_hidden: int = 2
    activation: str = "tanh"
    split_networks: bool = False
    critic_hidden_size: Optional[int] = None
    critic_num_hidden: Optional[int] = None
    num_conv_layers: int = 2
    conv_channels: List[int] = field(default_factory=lambda: [8, 8])
    kernel_size: int = 3
    cnn_fc_hidden_size: int = 32
    cnn_num_fc_layers: int = 1

    # Checkpointing / logging
    checkpoint_freq: int = 10_000
    log_freq: int = 1_000

    # Opponent pool
    opponent_pool_fraction: float = 0.25
    opponent_select_alpha: float = 0.1
    opponent_select_exponent: float = 2.0
    debug_opponents: bool = False
    # TPU addition: opponents kept device-resident per rotation (stacked
    # params); the reference lazily loads/unloads models per rotation.
    max_active_opponents: int = 8
    # TPU addition: PPO updates per opponent rotation. 1 = the
    # reference's exact per-update cadence (opponent_pool.rs:233-246);
    # W > 1 fuses W vs-pool updates into one device window — the
    # rotation and the win-rate EMA / rating folds then run once per
    # window instead of once per update (a documented cadence deviation;
    # the EMA sees the same games, batched coarser). Essential on
    # tunneled/multi-host setups where per-update dispatch dominates.
    # Must be a power of two: windows are sized in the power-of-2 family
    # the background precompile warms, so any other value would silently
    # run at the next power of two below it.
    pool_rotation_interval: int = 1

    # Experiment
    seed: Optional[int] = None
    run_name: Optional[str] = None
    forked_from: Optional[str] = None

    # --- TPU-native additions (no reference equivalent) ---------------
    compute_dtype: Optional[str] = None  # None (f32) or "bfloat16"
    mesh_data: int = 0  # data-parallel axis size; 0 = all local devices
    # Epoch-shuffle tile size: 0 = auto (exact per-sample shuffle at
    # reference batch sizes, tiled at TPU scale), 1 = always exact.
    shuffle_block_rows: int = 0
    # Runtime-guard policy for empty action masks / non-finite outputs:
    # "raise" (reference panics, utils.rs:115-135 + ppo.rs:363-366),
    # "warn" (log + continue), "off" (skip the device-side reductions).
    runtime_guards: str = "raise"

    def __post_init__(self):
        # Normalize flexible-typed fields on direct construction too.
        if not isinstance(self.player_count, PlayerCountMode):
            self.player_count = PlayerCountMode.parse(self.player_count)
        for k in self.SCHEDULE_FIELDS:
            v = getattr(self, k)
            if not isinstance(v, Schedule):
                setattr(self, k, Schedule.parse(v))
        for k in self.OPTIONAL_SCHEDULE_FIELDS:
            v = getattr(self, k)
            if v is not None and not isinstance(v, Schedule):
                setattr(self, k, Schedule.parse(v))

    # ------------------------------------------------------------------
    SCHEDULE_FIELDS = ("reward_shaping_coef", "learning_rate", "entropy_coef")
    OPTIONAL_SCHEDULE_FIELDS = ("adaptive_entropy",)

    def resolve_num_envs(self, num_devices: int = 1) -> int:
        """'auto' -> CPU count rounded up to a multiple of the mesh size
        (reference uses plain num_cpus, config.rs:732-740)."""
        if self.num_envs == "auto":
            n = os.cpu_count() or 8
        else:
            n = int(self.num_envs)
        if n % num_devices != 0:
            n = ((n // num_devices) + 1) * num_devices
        return max(n, num_devices)

    def effective_normalize_returns(self, num_players: int) -> bool:
        if self.normalize_returns is not None:
            return self.normalize_returns
        return num_players == 1

    def max_training_seconds(self) -> Optional[float]:
        if self.max_training_time is None:
            return None
        return parse_duration(self.max_training_time)

    # ------------------------------------------------------------------
    def validate(self) -> None:
        """Sanity checks mirroring reference Config::validate."""
        errors = []
        if self.num_steps <= 0:
            errors.append("num_steps must be > 0")
        if not 0.0 < self.gamma <= 1.0:
            errors.append("gamma must be in (0, 1]")
        if not 0.0 <= self.gae_lambda <= 1.0:
            errors.append("gae_lambda must be in [0, 1]")
        if not 0.0 < self.clip_epsilon < 1.0:
            errors.append("clip_epsilon must be in (0, 1)")
        if self.activation not in ("relu", "tanh"):
            errors.append(f"activation must be relu|tanh, got '{self.activation}'")
        if self.network_type not in ("mlp", "cnn", "ctde"):
            errors.append(f"network_type must be mlp|cnn|ctde, got '{self.network_type}'")
        if self.num_epochs <= 0 or self.num_minibatches <= 0:
            errors.append("num_epochs and num_minibatches must be > 0")
        if self.network_type == "cnn" and self.num_conv_layers < 1:
            # init() sizes fc_in from the final conv's channel count; with
            # zero conv layers the forward pass flattens raw input channels
            # instead and dies on an opaque trace-time shape mismatch.
            errors.append("num_conv_layers must be >= 1 for network_type=cnn")
        if not 0.0 <= self.opponent_pool_fraction <= 1.0:
            errors.append("opponent_pool_fraction must be in [0, 1]")
        if self.pool_rotation_interval < 1:
            errors.append("pool_rotation_interval must be >= 1")
        elif self.pool_rotation_interval & (self.pool_rotation_interval - 1):
            # train.py quantizes the window cap to the power-of-2 family
            # the precompile warms; reject rather than silently running
            # at a different cadence than configured.
            errors.append(
                "pool_rotation_interval must be a power of two "
                f"(got {self.pool_rotation_interval})"
            )
        if self.learning_rate.initial_value() <= 0:
            errors.append("learning_rate must be > 0")
        if self.entropy_coef.initial_value() < 0:
            errors.append("entropy_coef must be >= 0")
        if self.reward_shaping_coef.initial_value() < 0:
            errors.append("reward_shaping_coef must be >= 0")
        if self.adaptive_entropy is not None:
            if self.adaptive_entropy_min_coef < 0:
                errors.append("adaptive_entropy_min_coef must be >= 0")
            if self.adaptive_entropy_max_coef <= self.adaptive_entropy_min_coef:
                errors.append(
                    "adaptive_entropy_max_coef must be > adaptive_entropy_min_coef"
                )
            if self.adaptive_entropy_delta <= 0:
                errors.append("adaptive_entropy_delta must be > 0")
        from burn_ppo_torch.envs import registered_envs

        if self.env not in registered_envs():
            errors.append(
                f"Unknown environment '{self.env}'. Supported: "
                + ", ".join(sorted(registered_envs()))
            )
        if not 1 <= self.max_active_opponents <= 127:
            # Rotation slots pack to int8 in the pool record log
            # (train.py PoolRecordLog); >127 would wrap negative and
            # silently drop those opponents' stats.
            errors.append("max_active_opponents must be in [1, 127]")
        if self.max_training_time is not None:
            try:
                parse_duration(self.max_training_time)
            except ValueError as e:
                errors.append(str(e))
        if self.compute_dtype not in (None, "bfloat16"):
            errors.append("compute_dtype must be null or 'bfloat16'")
        if self.runtime_guards not in ("raise", "warn", "off"):
            errors.append("runtime_guards must be raise|warn|off")
        if errors:
            raise ValueError("Invalid config:\n  " + "\n  ".join(errors))

    # ------------------------------------------------------------------
    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        d = dict(d)
        known = {f.name for f in dataclasses.fields(Config)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        for k in Config.SCHEDULE_FIELDS:
            if k in d:
                d[k] = Schedule.parse(d[k])
        for k in Config.OPTIONAL_SCHEDULE_FIELDS:
            if k in d and d[k] is not None:
                d[k] = Schedule.parse(d[k])
        if "player_count" in d:
            d["player_count"] = PlayerCountMode.parse(d["player_count"])
        return Config(**d)

    @staticmethod
    def load(path: str | Path) -> "Config":
        with open(path, "rb") as f:
            data = tomllib.load(f)
        if "env" not in data:
            raise ValueError(f"Config {path} must specify 'env'")
        return Config.from_dict(data)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k in Config.SCHEDULE_FIELDS:
            d[k] = getattr(self, k).to_toml_value()
        for k in Config.OPTIONAL_SCHEDULE_FIELDS:
            v = getattr(self, k)
            d[k] = None if v is None else v.to_toml_value()
        d["player_count"] = self.player_count.to_toml_value()
        return d

    def save_toml(self, path: str | Path) -> None:
        """Frozen config snapshot in the run dir (main.rs:1939-1941)."""
        lines = []
        for k, v in self.to_dict().items():
            if v is None:
                continue
            lines.append(f"{k} = {_toml_repr(v)}")
        Path(path).write_text("\n".join(lines) + "\n")

    def apply_overrides(
        self, overrides: Dict[str, Any], *, resume: bool = False
    ) -> "Config":
        """CLI overrides; on resume only RESUME_OVERRIDABLE may change
        (config.rs:1158 / 1315)."""
        if resume:
            illegal = {
                k for k, v in overrides.items()
                if v is not None and k not in RESUME_OVERRIDABLE
            }
            if illegal:
                raise ValueError(
                    f"Cannot override {sorted(illegal)} on --resume; only "
                    f"{sorted(RESUME_OVERRIDABLE)} may change. Use --fork to "
                    "start a new run with different settings."
                )
        d = self.to_dict()
        for k, v in overrides.items():
            if v is not None:
                d[k] = v
        return Config.from_dict(d)


def _toml_repr(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_repr(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{k} = {_toml_repr(x)}" for k, x in v.items()) + "}"
    raise TypeError(f"Cannot TOML-encode {v!r}")


def generate_run_name(runs_dir: str | Path, env_name: str, parent: Optional[str] = None) -> str:
    """`{env}_{counter:03}` or `{parent}_child_{n:03}` (config.rs:1668-1676)."""
    runs_dir = Path(runs_dir)
    runs_dir.mkdir(parents=True, exist_ok=True)
    if parent is not None:
        prefix = f"{parent}_child_"
    else:
        prefix = f"{env_name}_"
    existing = set()
    for p in runs_dir.iterdir():
        if p.is_dir() and p.name.startswith(prefix):
            suffix = p.name[len(prefix):]
            if suffix.isdigit():
                existing.add(int(suffix))
    n = 1
    while n in existing:
        n += 1
    return f"{prefix}{n:03d}"
