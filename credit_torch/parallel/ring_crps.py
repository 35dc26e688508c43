"""Ring-CRPS: ensemble CRPS with one member per data-parallel rank: port of
credit_tpu/parallel/ring_crps.py.

credit_tpu shifts members around the ring with lax.ppermute inside
shard_map; the port sends them with point-to-point ops on the dp group.
As in the reference's ring (credit/losses/crps.py:17), received members
are constants: each rank's gradient flows only through its own member, and
the pairwise term is counted from both ends of every pair, so the
gradients summed over the ring are the dense estimator's.

CRPS estimator (fair, Zamo & Naveau): for member x_i of m members,
  skill_i  = |x_i - y|
  spread_i = (1/(m-1)) sum_{j != i} |x_i - x_j|
  crps     = mean_i skill_i - 0.5 * mean_i spread_i
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from credit_torch.parallel import distributed as D
from credit_torch.parallel.halo import all_reduce_sum


def _shift(buf: torch.Tensor, group) -> torch.Tensor:
    """buf from rank i - 1 of the ring (rank i's goes to i + 1)."""
    m, r = dist.get_world_size(group), dist.get_rank(group)
    out = torch.empty_like(buf)
    D.exchange([(buf, (r + 1) % m)], [(out, (r - 1) % m)], group)
    return out


def ring_crps(member: torch.Tensor, target: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's member (a field) and the shared target -> the fair CRPS
    of the ensemble, a scalar mean over the field and the ring, the same on
    every rank. m - 1 ring shifts of the member. Backward: the gradient of
    the ring's mean through this rank's member only."""
    m = dist.get_world_size(group)
    skill = torch.abs(member - target).mean()
    buf = member.detach()
    pair_sum = member.new_zeros(())
    for _ in range(m - 1):
        buf = _shift(buf, group)
        pair_sum = pair_sum + torch.abs(member - buf).mean()
    spread = pair_sum / max(m - 1, 1)
    # value skill - spread / 2; gradient skill - spread: the pair term's
    # other half is the peers' received copy of this member, which they
    # hold as a constant
    local = skill - spread + 0.5 * spread.detach()
    # every rank computes the same mean downstream: the identity backward
    return all_reduce_sum(local, group, reduce_grad=False) / m


def make_ring_crps_loss(group=None):
    """ring_crps from outside: takes members (m, ...) on every rank, one
    per rank of `group` (this rank's is members[rank]) and the target, and
    returns the scalar loss (reference: make_ring_crps_loss)."""

    def loss(members: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        r = dist.get_rank(group)
        return ring_crps(members[r], target, group)

    return loss


def dense_fair_crps(members: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The dense O(m^2) fair CRPS (the check used by reference
    tests/test_ring_crps.py), members (m, ...)."""
    m = members.shape[0]
    skill = torch.abs(members - target[None]).mean()
    diffs = torch.abs(members[:, None] - members[None, :]).mean(
        dim=tuple(range(2, members.dim() + 1)))
    spread = diffs.sum() / (m * (m - 1))
    return skill - 0.5 * spread
