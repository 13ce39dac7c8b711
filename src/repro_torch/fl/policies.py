"""Per-device codec policies: who gets which wire format.

A :class:`CodecPolicy` maps a round-``t`` dispatch to a device to a
:class:`~repro_torch.core.codecs.Codec` at a ``(p_s, p_q)`` operating point;
``SimConfig.codec_policy`` selects one from :data:`POLICIES`.

The port has ``static`` (the protocol's own global point for every
device, the default).  ``tier_aware`` and ``staleness_aware``, with the
per-device dispatch context and staleness estimates they read, arrive with
ROADMAP.md Queue A item 3 (the other policies and scenarios);
``make_policy`` raises for them until then.
"""
from __future__ import annotations

import abc
from typing import ClassVar, Dict, Optional, Tuple, Type

from repro_torch.core.codecs import Codec, resolve_codec
from repro_torch.fl.simulator import SimConfig

# where the not-yet-ported policies arrive
_LATER = {name: "ROADMAP.md Queue A item 3 (the other policies and scenarios)"
          for name in ("tier_aware", "staleness_aware")}


class CodecPolicy(abc.ABC):
    """Maps a dispatch to a codec + ``(p_s, p_q)`` operating point.

    * :meth:`codec_for` -- the strategy-facing entry point: the adapted
      point bound to the ``SimConfig.codec`` family;
    * :meth:`operating_point` -- the policy decision itself;
    * :meth:`observe_arrival` -- fed with each upload's staleness in rounds
      (a no-op for the static policy; it draws no RNG either way).
    """

    name: ClassVar[str] = ""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg

    def observe_arrival(self, device_id: int, staleness: float) -> None:
        pass

    @abc.abstractmethod
    def operating_point(self, t: int, device_id: Optional[int], p_s: float,
                        p_q: int) -> Tuple[float, int]:
        """The adapted ``(p_s, p_q)`` for this dispatch, given the
        protocol's base point."""

    def codec_for(self, t: int, device_id: Optional[int], p_s: float,
                  p_q: int) -> Codec:
        p_s, p_q = self.operating_point(t, device_id, p_s, p_q)
        return resolve_codec(self.cfg.codec, p_s, p_q,
                             iters=self.cfg.cohort_channel_iters)


class StaticPolicy(CodecPolicy):
    """The protocol's own global Alg. 5 point for every device."""

    name = "static"

    def operating_point(self, t, device_id, p_s, p_q):
        return p_s, p_q


POLICIES: Dict[str, Type[CodecPolicy]] = {StaticPolicy.name: StaticPolicy}


def make_policy(name: str, cfg: SimConfig) -> CodecPolicy:
    if name in _LATER:
        raise NotImplementedError(
            f"codec policy {name!r} is not ported yet: it arrives with "
            f"{_LATER[name]}")
    try:
        return POLICIES[name](cfg)
    except KeyError:
        raise ValueError(f"unknown codec policy {name!r}; "
                         f"expected one of {sorted(POLICIES)}") from None
