from burn_ppo_torch.envs.base import Environment, EnvSpec


def make_env(name: str) -> Environment:
    """Instantiate an environment by name. Only CartPole is ported so far;
    the multiplayer games follow ROADMAP A10 (Connect Four) and A13
    (Liar's Dice, Skull)."""
    if name == "cartpole":
        from burn_ppo_torch.envs.cartpole import CartPole

        return CartPole()
    raise NotImplementedError(
        f"environment {name!r} is not ported to burn_ppo_torch yet "
        "(ROADMAP A10: connect_four; A13: liars_dice, skull)"
    )


__all__ = ["Environment", "EnvSpec", "make_env"]
