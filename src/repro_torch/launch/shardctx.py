"""Sharding context: logical-axis resolution bound to one (mesh, rules)
(port of ``repro/launch/shardctx.py``).

``ShardCtx`` provides
  * ``act(x, logical)``    — redistribute a DTensor activation to the
                             placements its logical axes resolve to (the
                             ``sc`` hook of the models),
  * ``leaf(t, logical)``   — the ``MeshSharding`` of one tensor (a ``meta``
                             tensor will do),
  * ``tree(abstract, logical_tree)`` — the shardings of a whole tree, whose
    logical tree's leaves are axis tuples (str|None entries).
"""
from __future__ import annotations

from repro_torch.models.params import tree_map
from repro_torch.sharding import logical_sharding


class ShardCtx:
    def __init__(self, mesh, rules):
        self.mesh, self.rules = mesh, rules

    def act(self, x, logical):
        from torch.distributed.tensor import DTensor
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        pl = self.leaf(x, logical).placements
        return x if tuple(x.placements) == pl else x.redistribute(
            self.mesh, pl)

    def __call__(self, x, logical):
        return self.act(x, logical)

    def leaf(self, t, logical):
        return logical_sharding(t.shape, tuple(logical), self.rules,
                                self.mesh)

    def tree(self, abstract, logical_tree):
        return tree_map(self.leaf, abstract, logical_tree)


class NullCtx:
    """Unsharded stand-in."""
    def act(self, x, logical):
        return x

    def __call__(self, x, logical):
        return x
