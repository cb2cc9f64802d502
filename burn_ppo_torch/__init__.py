"""burn_ppo_torch — the PyTorch/CUDA port of burn_ppo_tpu.

The JAX package (``burn_ppo_tpu``) stays the reference; every module here
mirrors its counterpart's layout and is held against it by the
``tests/test_torch_*.py`` parity tests. The port imports ``torch`` and
never ``jax``, and nothing of ``burn_ppo_tpu``: it carries its own copies
of the host-only modules (``config``, ``schedule``, ``metrics``,
``progress``, the CLI parser in ``cli``, and ``selfplay/``: the opponent
pool, the rating history and the Plackett-Luce solver).

What XLA fused into one device program per env step on the TPU becomes
hand-written CUDA kernels for Hopper (``csrc/``), each behind a wrapper
that runs a plain PyTorch version for CPU tensors (``kernels/``).
"""

__version__ = "0.1.0"
