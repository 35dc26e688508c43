"""The stateless half of credit_tpu/postblock/stochastic.py: the pipeline
runner (`apply_postblocks_stateful`, `init_postblock_states`, reference
stochastic.py:187-207).

Stateful blocks (SKEBS and its pattern state, ROADMAP queue 1, item 5) are
not ported: a block with `is_stateful` raises. Their per-block state, PRNG
key and parameters come back with them.
"""

from __future__ import annotations

from credit_torch.postblock import apply_postblocks


def check_stateless(blocks) -> None:
    """Raise for a stateful block: none is ported yet."""
    for b in blocks:
        if getattr(b, "is_stateful", False):
            raise NotImplementedError(
                f"stateful postblock {type(b).__name__} is not ported yet (SKEBS and the "
                "stateful path: ROADMAP queue 1, item 5)")


def apply_postblocks_stateful(blocks, y_pred, x, states: dict):
    """Apply the pipeline; returns (y_pred, states). Every ported block is
    stateless, so this is `apply_postblocks` with the states passed on."""
    check_stateless(blocks)
    return apply_postblocks(blocks, y_pred, x), dict(states)


def init_postblock_states(blocks, batch_size: int) -> dict:
    check_stateless(blocks)
    return {}
