"""Terminal human-player input loop.

Counterpart of burn_ppo_tpu/human.py (reference src/human.rs:31-115): a
prompt with the action mask enforced, and the commands help, render,
random, hint and quit. The state is one env, a batch of one, on any
device; the text helpers read it on the host.
"""

from __future__ import annotations

import random
import sys

import numpy as np
import torch

from burn_ppo_torch.envs.base import env_row
from burn_ppo_torch.ppo.normalization import obs_norm_apply

HELP = """Commands:
  <action>   play an action (see the game's action format)
  help       show this help
  render     re-draw the board/state
  random     play a random valid action
  hint       show the model's action probabilities (if available)
  quit       exit the game
"""


def random_valid_action(env, state) -> int:
    mask = env.action_mask(env_row(state))[0].numpy()
    valid = np.nonzero(mask)[0]
    return int(random.choice(valid.tolist()))


def _hint_logits(env, state, source) -> np.ndarray:
    """The model's policy logits of the env, f32 on the host."""
    device = next(source.network.parameters()).device
    obs = env.obs(env_row(state)).to(device)
    if source.obs_norm is not None:
        obs = obs_norm_apply(source.obs_norm, obs)
    with torch.no_grad():
        return source.network.forward_actor(obs)[0].cpu().numpy()


def prompt_human_action(env, state, hint_source=None) -> int:
    """Prompt until a valid action is given (mask-validated)."""
    mask = env.action_mask(env_row(state))[0].numpy()
    while True:
        try:
            text = input("your move> ").strip()
        except EOFError:
            print("\n(quit)")
            sys.exit(0)
        if not text:
            continue
        low = text.lower()
        if low in ("quit", "exit", "q"):
            sys.exit(0)
        if low == "help":
            print(HELP)
            continue
        if low == "render":
            rendered = env.render(state)
            print(rendered if rendered else "(no renderer)")
            continue
        if low == "random":
            action = random_valid_action(env, state)
            print(f"(random) {env.describe_action(action)}")
            return action
        if low == "hint":
            if hint_source is None:
                print("(no model available for hints)")
                continue
            logits = _hint_logits(env, state, hint_source)
            logits[~mask.astype(bool)] = -1e9
            probs = np.exp(logits - logits.max())
            probs /= probs.sum()
            order = np.argsort(-probs)
            for a in order[:5]:
                if mask[a]:
                    print(f"  {env.describe_action(int(a))}: {probs[a]:.1%}")
            continue
        try:
            action = env.parse_action(text)
        except Exception as e:  # noqa: BLE001 - any parse failure re-prompts
            print(f"invalid input: {e}")
            continue
        if action < 0 or action >= env.spec.num_actions or not mask[action]:
            print("that action is not legal right now")
            continue
        return action
