"""Server-side TEASQ-Fed state machine (paper Algs. 1-2, server process).

Distributor: admission-controls task requests with the C-fraction gate.
Receiver/Updater: caches K = ceil(N*gamma) updates, then performs the
staleness-weighted aggregation of Eqs. 6-10 on the parameters' device.

``SERVERS`` registers the server backends; the port has ``"single"``.
The sharded backend arrives with ROADMAP.md Queue A item 1 (the mesh
slice) and raises until then.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.staleness import (aggregate_cache,
                                        aggregate_cache_stacked)
from repro_torch.utils.tree import Params


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


SERVERS: Dict[str, type] = {"single": TeasqServer}

# where the not-yet-ported backends arrive
_LATER = {"sharded": "ROADMAP.md Queue A item 1 (the mesh slice: "
                      "sharding over torch.distributed)"}


def make_server(name: str, w_init: Params, cfg: ServerConfig, *,
                shards: int = 0) -> TeasqServer:
    """Resolve ``SimConfig.server`` to a constructed server backend."""
    if name in _LATER:
        raise NotImplementedError(
            f"server {name!r} is not ported yet: it arrives with "
            f"{_LATER[name]}")
    try:
        cls = SERVERS[name]
    except KeyError:
        raise ValueError(f"unknown server {name!r}; "
                         f"expected one of {sorted(SERVERS)}") from None
    return cls(w_init, cfg)
