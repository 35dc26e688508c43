"""Parameter layout of scan-over-blocks stages (port of
credit_tpu/models/scan_utils.py `unstack_block_params`, and of the layout of
credit_tpu/models/swin.py `SwinStageV2(scan_blocks=True)`).

credit_tpu's `scan_blocks=True` stacks a CrossFormer stage's `depth`
identical blocks on a leading axis under `blocks/<name>`, and a SwinV2
stage's depth/2 (plain, shifted) block pairs under `blocks/b0` and
`blocks/b1`; its training bench checkpoints are in that layout. The port
always runs the blocks unrolled (`short_attn0..N-1`, `block0..depth-1`), so
the bridge unstacks them first.
"""

from __future__ import annotations

from typing import Any

BLOCK_BASES = ("short_attn", "short_ff", "long_attn", "long_ff")
PAIR_BASES = ("b0", "b1")  # SwinV2: pair i holds block 2i (b0) and 2i + 1 (b1)


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
    pairs = isinstance(blocks, dict) and set(blocks) == set(PAIR_BASES)
    if isinstance(blocks, dict) and (pairs or any(b in blocks for b in BLOCK_BASES)):
        out = {k: unstack_block_params(v) for k, v in tree.items() if k != "blocks"}
        for base, sub in blocks.items():
            leaf = sub
            while isinstance(leaf, dict):
                leaf = next(iter(leaf.values()))
            for i in range(int(leaf.shape[0])):
                if pairs:
                    out[f"block{2 * i + PAIR_BASES.index(base)}"] = _index(sub, i)
                else:
                    out[f"{base}{i}"] = _index(sub, i)
        return out
    return {k: unstack_block_params(v) for k, v in tree.items()}
