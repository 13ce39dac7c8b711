"""Per-device codec policies: who gets which wire format.

A :class:`CodecPolicy` maps the *dispatch context* of a round-``t``
dispatch (the round, the device id, the device's bandwidth/compute tier
from ``ScenarioConfig.tiers``, and a per-device staleness estimate fed by
the engine's arrival handlers) to a :class:`~repro_torch.core.codecs.Codec`
at a per-device ``(p_s, p_q)`` operating point.  ``SimConfig.codec_policy``
selects one from :data:`POLICIES`:

* ``static`` -- the protocol's own global point for every device (the
  default);
* ``tier_aware`` -- per-bandwidth-tier points: explicit
  ``SimConfig.tier_points`` (e.g. from ``profile_compression(...,
  tiers=...)``), or the base point stepped ``round(log2(1 /
  bandwidth_scale))`` notches toward more compression along the Alg. 5
  candidate sets;
* ``staleness_aware`` -- devices whose EWMA staleness crosses successive
  ``stale_per_notch`` thresholds get extra compression notches.

Policies only adapt *compressing* dispatches: a protocol whose base point
is uncompressed keeps dense f32 on the wire under every policy.  All of
it is host numpy, with the JAX package's arithmetic, so the chosen points
and the staleness estimates equal its own.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import ClassVar, Dict, Optional, Sequence, Tuple, Type

import numpy as np

from repro_torch.core.codecs import Codec, resolve_codec
from repro_torch.core.compression import FLOAT_BITS
from repro_torch.core.dynamic import DEFAULT_SET_Q, DEFAULT_SET_S
from repro_torch.fl.simulator import SimConfig, tier_assignment


@dataclasses.dataclass(frozen=True)
class DispatchContext:
    """Everything a policy may condition on for one round-``t`` dispatch."""
    t: int
    device_id: Optional[int]
    tier: int                  # index into ScenarioConfig.tiers (0 if none)
    bandwidth_scale: float     # the tier's link scaling (<1 = slower)
    compute_scale: float       # the tier's compute scaling (>1 = slower)
    staleness: float           # EWMA of the device's observed staleness


def _nearest_idx(candidates: Sequence, x) -> int:
    return min(range(len(candidates)), key=lambda i: abs(candidates[i] - x))


def notch_point(p_s: float, p_q: int, notches: int,
                set_s: Sequence[float] = DEFAULT_SET_S,
                set_q: Sequence[int] = DEFAULT_SET_Q) -> Tuple[float, int]:
    """Step an operating point ``notches`` steps toward more compression
    along the Alg. 5 candidate sets (clamped at the most compressed entry).
    ``notches=0`` snaps to the nearest candidate pair without moving."""
    si = min(_nearest_idx(set_s, p_s) + notches, len(set_s) - 1)
    qi = min(_nearest_idx(set_q, p_q) + notches, len(set_q) - 1)
    return set_s[si], set_q[qi]


class CodecPolicy(abc.ABC):
    """Maps a dispatch context to a codec + ``(p_s, p_q)`` operating point.

    * :meth:`codec_for` / :meth:`codecs_for` -- the strategy-facing entry
      points (one device, a grant wave): adapt only compressing dispatches
      and bind the point to the ``SimConfig.codec`` family;
    * :meth:`operating_point` -- the policy decision itself;
    * :meth:`observe_arrival` / :meth:`observe_arrivals` -- fed with each
      upload's staleness in rounds: a per-device EWMA, one vectorized
      scatter for a group of distinct devices (the scalar hook is a group
      of one).  It draws no RNG.
    """

    name: ClassVar[str] = ""
    staleness_beta: ClassVar[float] = 0.5     # EWMA update weight

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        tiers = cfg.scenario.tiers if cfg.scenario is not None else None
        self.tiers = list(tiers) if tiers else []
        self.tier_of = tier_assignment(cfg.n_devices, tiers)
        self.bandwidth_scale = np.asarray(
            [t.bandwidth_scale for t in self.tiers] or [1.0])
        self.compute_scale = np.asarray(
            [t.compute_scale for t in self.tiers] or [1.0])
        self.staleness_est = np.zeros(cfg.n_devices)

    def _known(self, device_id: Optional[int]) -> bool:
        # ids beyond cfg.n_devices fall back to tier 0 / fresh
        return device_id is not None and 0 <= device_id < len(self.tier_of)

    def observe_arrival(self, device_id: int, staleness: float) -> None:
        self.observe_arrivals([device_id], [staleness])

    def observe_arrivals(self, device_ids, staleness) -> None:
        """EWMA update over a group of arrivals, unknown ids dropped.
        Updates of distinct devices commute, so a group of distinct ids is
        one fused scatter; repeated ids are applied one by one in order."""
        ids = np.asarray(device_ids, np.int64)
        st = np.asarray(staleness, np.float64)
        ok = (ids >= 0) & (ids < len(self.tier_of))
        if not ok.all():
            ids, st = ids[ok], st[ok]
        if not len(ids):
            return
        b = self.staleness_beta
        est = self.staleness_est
        if len(ids) == 1 or len(np.unique(ids)) == len(ids):
            est[ids] = (1.0 - b) * est[ids] + b * st
        else:
            for i, s in zip(ids.tolist(), st.tolist()):
                est[i] = (1.0 - b) * est[i] + b * s

    def state_dict(self) -> Dict[str, np.ndarray]:
        """The policy's mutable state: the per-device staleness EWMAs."""
        return {"staleness_est": np.asarray(self.staleness_est)}

    def load_state(self, state: Dict[str, np.ndarray]) -> None:
        self.staleness_est[:] = np.asarray(state["staleness_est"])

    def context(self, t: int, device_id: Optional[int]) -> DispatchContext:
        known = self._known(device_id)
        tier = int(self.tier_of[device_id]) if known else 0
        stale = float(self.staleness_est[device_id]) if known else 0.0
        return DispatchContext(t, device_id, tier,
                               float(self.bandwidth_scale[tier]),
                               float(self.compute_scale[tier]), stale)

    @abc.abstractmethod
    def operating_point(self, ctx: DispatchContext, p_s: float,
                        p_q: int) -> Tuple[float, int]:
        """The adapted ``(p_s, p_q)`` for this dispatch, given the
        protocol's base point."""

    def _resolve(self, p_s: float, p_q: int) -> Codec:
        return resolve_codec(self.cfg.codec, p_s, p_q,
                             iters=self.cfg.cohort_channel_iters)

    def codec_for(self, t: int, device_id: Optional[int], p_s: float,
                  p_q: int) -> Codec:
        if p_s < 1.0 or p_q < FLOAT_BITS:   # only adapt compressing rounds
            p_s, p_q = self.operating_point(self.context(t, device_id),
                                            p_s, p_q)
        return self._resolve(p_s, p_q)

    def codecs_for(self, t: int, device_ids, p_s: float,
                   p_q: int) -> list:
        """:meth:`codec_for` over a grant wave (per device by default)."""
        return [self.codec_for(t, int(k), p_s, p_q) for k in device_ids]


class StaticPolicy(CodecPolicy):
    """The protocol's own global Alg. 5 point for every device."""

    name = "static"

    def observe_arrival(self, device_id, staleness) -> None:
        pass

    def observe_arrivals(self, device_ids, staleness) -> None:
        pass

    def operating_point(self, ctx, p_s, p_q):
        return p_s, p_q

    def codec_for(self, t, device_id, p_s, p_q) -> Codec:
        return self._resolve(p_s, p_q)

    def codecs_for(self, t, device_ids, p_s, p_q) -> list:
        # one resolve, one shared (frozen) instance across the wave
        return [self._resolve(p_s, p_q)] * len(device_ids)


class TierAwarePolicy(CodecPolicy):
    """Each bandwidth tier gets its own operating point: explicit
    ``SimConfig.tier_points`` (index i = ``scenario.tiers[i]``) win;
    without them the base point is stepped ``round(log2(1 /
    bandwidth_scale))`` notches toward more compression, so full-rate
    tiers (or a fleet without tiers) keep the protocol's point."""

    name = "tier_aware"

    def operating_point(self, ctx, p_s, p_q):
        points = self.cfg.tier_points
        if points:
            p_s, p_q = points[min(ctx.tier, len(points) - 1)]
            return float(p_s), int(p_q)
        b = max(ctx.bandwidth_scale, 1e-9)
        notches = max(0, int(round(np.log2(1.0 / b))))
        return notch_point(p_s, p_q, notches) if notches else (p_s, p_q)

    def codecs_for(self, t, device_ids, p_s, p_q) -> list:
        """The point reads only the device's tier: one resolve per distinct
        tier of the wave."""
        if not (p_s < 1.0 or p_q < FLOAT_BITS):
            return [self._resolve(p_s, p_q)] * len(device_ids)
        ids = np.asarray(device_ids, np.int64)
        known = (ids >= 0) & (ids < len(self.tier_of))
        tiers = np.where(known,
                         self.tier_of[np.clip(ids, 0,
                                              len(self.tier_of) - 1)], 0)
        out: list = [None] * len(ids)
        for tier in np.unique(tiers).tolist():
            ctx = DispatchContext(t, None, tier,
                                  float(self.bandwidth_scale[tier]),
                                  float(self.compute_scale[tier]), 0.0)
            codec = self._resolve(*self.operating_point(ctx, p_s, p_q))
            for i in np.flatnonzero(tiers == tier).tolist():
                out[i] = codec
        return out


class StalenessAwarePolicy(CodecPolicy):
    """Eq. 9 down-weights an update by its staleness, so the wire bits of a
    chronically stale device buy less aggregation mass: devices whose EWMA
    staleness crosses successive ``stale_per_notch`` thresholds ship
    ``1..max_notches`` extra compression notches."""

    name = "staleness_aware"
    stale_per_notch: ClassVar[float] = 2.0   # EWMA rounds per extra notch
    max_notches: ClassVar[int] = 2

    def operating_point(self, ctx, p_s, p_q):
        notches = min(self.max_notches,
                      int(ctx.staleness // self.stale_per_notch))
        return notch_point(p_s, p_q, notches) if notches else (p_s, p_q)


POLICIES: Dict[str, Type[CodecPolicy]] = {
    cls.name: cls for cls in (StaticPolicy, TierAwarePolicy,
                              StalenessAwarePolicy)
}


def make_policy(name: str, cfg: SimConfig) -> CodecPolicy:
    try:
        return POLICIES[name](cfg)
    except KeyError:
        raise ValueError(f"unknown codec policy {name!r}; "
                         f"expected one of {sorted(POLICIES)}") from None
