from burn_ppo_torch.envs.base import Environment, EnvSpec


def make_env(name: str) -> Environment:
    """Instantiate an environment by name. CartPole and Connect Four are
    ported; Liar's Dice and Skull follow ROADMAP A13."""
    if name == "cartpole":
        from burn_ppo_torch.envs.cartpole import CartPole

        return CartPole()
    if name == "connect_four":
        from burn_ppo_torch.envs.connect_four import ConnectFour

        return ConnectFour()
    raise NotImplementedError(
        f"environment {name!r} is not ported to burn_ppo_torch yet "
        "(ROADMAP A13: liars_dice, skull)"
    )


__all__ = ["Environment", "EnvSpec", "make_env"]
