"""Server-side TEASQ-Fed state machine (paper Algs. 1-2, server process).

Distributor: admission-controls task requests with the C-fraction gate.
Receiver/Updater: caches K = ceil(N*gamma) updates, then performs the
staleness-weighted aggregation of Eqs. 6-10 on the parameters' device.

``SERVERS`` registers the server backends:

* ``"single"`` -- :class:`TeasqServer`, the single-device reference;
* ``"sharded"`` -- :class:`ShardedTeasqServer`, which partitions the
  flattened weight vector over a 1-D mesh of the ranks of the
  ``torch.distributed`` world and runs the stacked Eqs. 6-10 reduction a
  column block per rank; in a world of 1 (or at ``shards=1``) it is the
  parent's exact path.

``SimConfig.server`` selects the backend; ``make_server`` resolves it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.staleness import (aggregate_cache,
                                        aggregate_cache_stacked,
                                        make_sharded_aggregator)
from repro_torch.utils.tree import Params, leaves


@dataclasses.dataclass
class ServerConfig:
    n_devices: int
    c_fraction: float = 0.1     # C: max fraction of devices training in parallel
    gamma: float = 0.1          # cache fraction: K = ceil(N * gamma)
    alpha: float = 0.6          # mixing hyper-parameter (Eq. 9)
    a: float = 0.5              # staleness exponent (Eq. 6)

    @functools.cached_property
    def max_parallel(self) -> int:
        return max(1, math.ceil(self.n_devices * self.c_fraction))

    @functools.cached_property
    def cache_size(self) -> int:
        return max(1, math.ceil(self.n_devices * self.gamma))


class TeasqServer:
    """Holds the global model, round counter t, active count P and cache Q."""

    def __init__(self, w_init: Params, cfg: ServerConfig):
        self.cfg = cfg
        self.w = w_init
        self.t = 0
        self.active = 0                      # P
        self.cache: List[Tuple[Params, int, int]] = []   # (w_local, h_c, n_c)

    # -- Distributor (Alg. 1 server) ------------------------------------
    def try_dispatch(self) -> Optional[Tuple[Params, int]]:
        """Admit a task request: returns (w^t, t) or None if P >= ceil(N*C)."""
        if self.active >= self.cfg.max_parallel:
            return None
        self.active += 1
        return self.w, self.t

    # -- Receiver + Updater (Alg. 2) ------------------------------------
    def _aggregate(self) -> Params:
        return aggregate_cache(self.w, self.cache, self.t,
                               self.cfg.alpha, self.cfg.a)

    def _aggregate_stacked(self) -> Params:
        """Eqs. 6-10 in the stacked form (wave mode)."""
        return aggregate_cache_stacked(self.w, self.cache, self.t,
                                       self.cfg.alpha, self.cfg.a)

    def receive(self, w_local: Params, h: int, n_samples: int) -> bool:
        """Push an update; aggregate when the cache reaches K.
        Returns True if an aggregation round completed."""
        self.active = max(0, self.active - 1)
        self.cache.append((w_local, h, n_samples))
        if len(self.cache) < self.cfg.cache_size:
            return False
        self.w = self._aggregate()
        self.cache.clear()
        self.t += 1
        return True

    def receive_many(self, entries: List[Tuple[Params, int, int]]
                     ) -> List[bool]:
        """Wave-mode Receiver (Alg. 2 over an arrival group): the
        ``(w_local, h_c, n_c)`` entries in event order, aggregating at every
        cache fill in the stacked form.  The same cache and round
        semantics as one :meth:`receive` per entry; returns their flags."""
        done = []
        for w_local, h, n_samples in entries:
            self.active = max(0, self.active - 1)
            self.cache.append((w_local, h, n_samples))
            if len(self.cache) < self.cfg.cache_size:
                done.append(False)
                continue
            self.w = self._aggregate_stacked()
            self.cache.clear()
            self.t += 1
            done.append(True)
        return done


class ShardedTeasqServer(TeasqServer):
    """`TeasqServer` with the Eqs. 6-10 reduction sharded over a mesh.

    Every rank of the ``torch.distributed`` world runs the same event
    loop.  The flattened weight vector is split into ``n_shards`` equal
    column blocks over the ``"agg"`` axis of a ``(world / n_shards,
    n_shards)`` mesh of every rank (``n_shards`` must divide the world:
    each group along ``"agg"`` reduces the whole vector), and both the
    serial and the wave receive paths reduce through ONE flat sharded
    aggregator (``make_sharded_aggregator``): each rank reduces its block
    and the blocks are all-gathered, so every rank ends each aggregation
    with the same weights, within 1 ulp of ``aggregate_cache_stacked``.

    With ``n_shards`` resolving to 1 (no world, a world of 1, or
    ``shards=1``) no mesh is built and no collective runs: BOTH paths are
    the parent's kernels, bit-identical to :class:`TeasqServer`."""

    def __init__(self, w_init: Params, cfg: ServerConfig, n_shards: int = 0):
        super().__init__(w_init, cfg)
        import torch
        import torch.distributed as dist
        world = dist.get_world_size() if dist.is_initialized() else 1
        want = int(n_shards) if n_shards > 0 else world
        self.n_shards = max(1, min(want, world))
        if world % self.n_shards:
            raise ValueError(f"{self.n_shards} shards do not divide a world "
                             f"of {world}")
        self.mesh = None
        self._agg = None
        if self.n_shards > 1:
            # every rank is in the mesh, so all make the same groups
            from torch.distributed.device_mesh import DeviceMesh
            self.mesh = DeviceMesh(
                leaves(w_init)[0].device.type,
                torch.arange(world).reshape(-1, self.n_shards),
                mesh_dim_names=("rep", "agg"))
            self._agg = make_sharded_aggregator(self.mesh)

    def _aggregate(self) -> Params:
        if self._agg is None:      # degenerate mesh: exact parent path
            return super()._aggregate()
        return self._agg(self.w, self.cache, self.t,
                         self.cfg.alpha, self.cfg.a)

    # one flat sharded reduction serves both receive paths: the stacked
    # and the serial single-device forms differ only in reduction order,
    # and the sharded reduction follows the stacked one
    _aggregate_stacked = _aggregate


# server registry: SimConfig.server -> class
SERVERS: Dict[str, type] = {
    "single": TeasqServer,
    "sharded": ShardedTeasqServer,
}


def make_server(name: str, w_init: Params, cfg: ServerConfig, *,
                shards: int = 0) -> TeasqServer:
    """Resolve ``SimConfig.server`` to a constructed server backend.
    ``shards`` (``SimConfig.server_shards``) caps the mesh width of a
    sharded backend: 0 means the whole world."""
    try:
        cls = SERVERS[name]
    except KeyError:
        raise ValueError(f"unknown server {name!r}; "
                         f"expected one of {sorted(SERVERS)}") from None
    if issubclass(cls, ShardedTeasqServer):
        return cls(w_init, cfg, n_shards=shards)
    return cls(w_init, cfg)
