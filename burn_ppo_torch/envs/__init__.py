from burn_ppo_torch.envs.base import Environment, EnvSpec


def registered_envs():
    """Every env name a config may name (burn_ppo_tpu/envs/__init__.py
    registers the same four): Liar's Dice validates as in the JAX package,
    and ``make_env`` refuses it with its ROADMAP item."""
    return {"cartpole", "connect_four", "liars_dice", "skull"}


def make_env(name: str) -> Environment:
    """Instantiate an environment by name. CartPole, Connect Four and Skull
    (four players; ``with_num_players`` for 2-6) are ported; Liar's Dice
    follows ROADMAP A13/B12."""
    if name == "cartpole":
        from burn_ppo_torch.envs.cartpole import CartPole

        return CartPole()
    if name == "connect_four":
        from burn_ppo_torch.envs.connect_four import ConnectFour

        return ConnectFour()
    if name == "skull":
        from burn_ppo_torch.envs.skull import Skull

        return Skull()
    raise NotImplementedError(
        f"environment {name!r} is not ported to burn_ppo_torch yet "
        "(ROADMAP A13/B12: liars_dice)"
    )


__all__ = ["Environment", "EnvSpec", "make_env", "registered_envs"]
