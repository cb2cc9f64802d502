from burn_ppo_torch.envs.base import Environment, EnvSpec


def registered_envs():
    """Every env name a config may name (burn_ppo_tpu/envs/__init__.py
    registers the same four)."""
    return {"cartpole", "connect_four", "liars_dice", "skull"}


def make_env(name: str) -> Environment:
    """Instantiate an environment by name: CartPole, Connect Four, Liar's
    Dice (four players) or Skull (four players; ``with_num_players`` for
    2-6)."""
    if name == "cartpole":
        from burn_ppo_torch.envs.cartpole import CartPole

        return CartPole()
    if name == "connect_four":
        from burn_ppo_torch.envs.connect_four import ConnectFour

        return ConnectFour()
    if name == "skull":
        from burn_ppo_torch.envs.skull import Skull

        return Skull()
    if name == "liars_dice":
        from burn_ppo_torch.envs.liars_dice import LiarsDice

        return LiarsDice()
    raise ValueError(f"unknown environment {name!r}; known: {sorted(registered_envs())}")


__all__ = ["Environment", "EnvSpec", "make_env", "registered_envs"]
