"""Host-side helpers of the front ends.

Counterpart of burn_ppo_tpu/utils.py:47-67 (``rewards_to_placements``),
which the port keeps its own copy of: the JAX package is never imported.
"""

from __future__ import annotations

from typing import List, Sequence


def rewards_to_placements(rewards: Sequence[float]) -> List[int]:
    """Final per-player rewards -> 1-indexed competition-ranked placements
    ('1224' style): higher reward places better, and rewards within 1e-6
    of a tie group's LEADER share its placement (the reference's inner
    loop, eval.rs:290-293), so accumulated float rewards that nearly tie
    are not split."""
    indexed = sorted(enumerate(rewards), key=lambda t: -t[1])
    n = len(indexed)
    placements = [0] * n
    i = 0
    while i < n:
        leader = indexed[i][1]
        j = i
        while j < n and abs(indexed[j][1] - leader) < 1e-6:
            j += 1
        for k in range(i, j):
            placements[indexed[k][0]] = i + 1
        i = j
    return placements
