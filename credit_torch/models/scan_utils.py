"""Parameter layout of scan-over-blocks Transformer stages (port of
credit_tpu/models/scan_utils.py `unstack_block_params`).

credit_tpu's `scan_blocks=True` stacks a stage's `depth` identical blocks
on a leading axis under `blocks/<name>`; its training bench checkpoints are
in that layout. The port always runs the blocks unrolled
(`short_attn0..N-1`), so the bridge unstacks them first.
"""

from __future__ import annotations

from typing import Any

BLOCK_BASES = ("short_attn", "short_ff", "long_attn", "long_ff")


def _index(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def unstack_block_params(tree: Any) -> Any:
    """Scan layout -> unrolled layout, for a nested dict of arrays or
    tensors (a params or a spectral tree); other nodes pass through."""
    if not isinstance(tree, dict):
        return tree
    blocks = tree.get("blocks")
    if isinstance(blocks, dict) and any(b in blocks for b in BLOCK_BASES):
        out = {k: unstack_block_params(v) for k, v in tree.items() if k != "blocks"}
        for base, sub in blocks.items():
            leaf = sub
            while isinstance(leaf, dict):
                leaf = next(iter(leaf.values()))
            for i in range(int(leaf.shape[0])):
                out[f"{base}{i}"] = _index(sub, i)
        return out
    return {k: unstack_block_params(v) for k, v in tree.items()}
