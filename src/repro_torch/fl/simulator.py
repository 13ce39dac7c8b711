"""Simulation configuration and log records of the event-driven FL engine.

The JAX package's module also holds the legacy monolithic ``FLSimulator``;
the port keeps only what its engine needs: :class:`SimConfig` (the same
fields and defaults), :class:`LogEntry`, the scenario knobs
(:class:`ScenarioConfig`, :class:`TierSpec`), ``tier_assignment``, and
MOON's local update (``moon_local_train``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.dynamic import CompressionSchedule
from repro_torch.core.latency import ComputeConfig, WirelessConfig
from repro_torch.utils.tree import Path, leaves, paths, unflatten

Params = Dict[str, torch.Tensor]


def _moon_sgd_step(params: List[torch.Tensor], names: List[Path],
                   images: torch.Tensor, labels: torch.Tensor,
                   z_glob: torch.Tensor, z_prev: torch.Tensor, lr: float,
                   mu_con: float, tau: float, forward_fn: Callable,
                   features_fn: Callable) -> List[torch.Tensor]:
    """MOON (Li et al., CVPR'21) local step: CE + model-contrastive loss
    pulling the representation toward the global model's (``z_glob``) and
    away from the device's previous local model's (``z_prev``), then one
    plain SGD step."""
    for p in params:
        p.requires_grad_(True)
    w = unflatten(names, params)
    logp = F.log_softmax(forward_fn(w, images), dim=-1)
    ce = -torch.gather(logp, 1, labels.long()[:, None]).mean()
    z = features_fn(w, images)

    def cos(a, b):
        return (a * b).sum(-1) / (torch.linalg.norm(a, dim=-1)
                                  * torch.linalg.norm(b, dim=-1) + 1e-8)

    sim_g = cos(z, z_glob) / tau
    sim_p = cos(z, z_prev) / tau
    lcon = -(sim_g - torch.logaddexp(sim_g, sim_p)).mean()
    grads = torch.autograd.grad(ce + mu_con * lcon, params)
    with torch.no_grad():
        return [p - lr * g for p, g in zip(params, grads)]


def moon_local_train(w_glob: Params, prev: Params, x: torch.Tensor,
                     y: torch.Tensor, *, epochs: int, batch_size: int,
                     lr: float, rng: np.random.RandomState,
                     forward_fn: Callable, features_fn: Callable,
                     mu_con: float = 1.0, tau: float = 0.5) -> Params:
    """MOON device-side update: E epochs of ``_moon_sgd_step`` minibatches
    from ``w_glob``, the minibatch order drawn from ``rng`` (one
    permutation per epoch, as in the JAX package).  The global and
    previous models' features carry no gradient."""
    if forward_fn is None or features_fn is None:
        raise ValueError(
            "MOON's model-contrastive term needs the task's forward and "
            "features heads (FLTask.forward / FLTask.features)")
    names = paths(w_glob)
    params = [v.detach() for v in leaves(w_glob)]
    n = len(y)
    for _ in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(x.device)
        for s in range(0, n - batch_size + 1, batch_size):
            sel = order[s:s + batch_size]
            images, labels = x[sel], y[sel]
            with torch.no_grad():
                z_glob = features_fn(w_glob, images)
                z_prev = features_fn(prev, images)
            params = _moon_sgd_step(params, names, images, labels, z_glob,
                                    z_prev, lr, mu_con, tau, forward_fn,
                                    features_fn)
    return unflatten(names, params)


@dataclasses.dataclass
class TierSpec:
    """One heterogeneity tier: a fraction of the fleet with scaled compute
    speed (multiplies the shifted-exponential coefficient a_k; >1 = slower)
    and scaled link bandwidth (multiplies both directions' rates;
    <1 = slower links)."""
    fraction: float
    compute_scale: float = 1.0
    bandwidth_scale: float = 1.0
    name: str = ""


def tier_assignment(n_devices: int,
                    tiers: Optional[List[TierSpec]]) -> np.ndarray:
    """Contiguous deterministic tier indices by device id: tier ``i`` covers
    the next ``round(fraction_i * n)`` devices and the last tier absorbs the
    remainder."""
    tier = np.zeros(n_devices, np.int64)
    if not tiers:
        return tier
    start = 0
    for i, t in enumerate(tiers):
        stop = n_devices if i == len(tiers) - 1 else min(
            n_devices, start + int(round(t.fraction * n_devices)))
        tier[start:stop] = i
        start = stop
    return tier


@dataclasses.dataclass
class ScenarioConfig:
    """Scenario-injection knobs, drawn from a dedicated RNG stream so that
    an all-zero scenario leaves the engine's event stream unchanged.

    * ``dropout_prob``: per-task probability the device leaves the fleet
      mid-round (permanent); its slot is freed and re-dispatched.
    * ``failure_prob``: per-task probability of a transient mid-round
      crash; the device retries after ``retry_backoff`` simulated seconds.
    * ``tiers``: heterogeneous compute/bandwidth ``TierSpec`` tiers,
      assigned contiguously by device index (see ``tier_assignment``).
    """
    dropout_prob: float = 0.0
    failure_prob: float = 0.0
    retry_backoff: float = 1.0
    tiers: Optional[List[TierSpec]] = None

    @property
    def active(self) -> bool:
        return (self.dropout_prob > 0.0 or self.failure_prob > 0.0
                or bool(self.tiers))


@dataclasses.dataclass
class SimConfig:
    """Every knob of a simulated run, with the JAX package's names and
    defaults (see its ``SimConfig`` docstring for each one).  The port runs
    both schedulers (``"heap"``, ``"batched"``), both handler modes
    (``"serial"``; ``"wave"`` on the batched scheduler only), every codec
    policy, and ``server="single"`` (``"sharded"`` raises until ROADMAP.md
    Queue A item 4 ports it), with the serial trainer or, at
    ``cohort_size > 0``, the cohort trainer."""

    method: str = "teasq"
    task: str = "fmnist_cnn"
    n_devices: int = 100
    c_fraction: float = 0.1
    gamma: float = 0.1
    alpha: float = 0.6
    a: float = 0.5
    mu: float = 0.01
    epochs: int = 2
    batch_size: int = 40
    lr: float = 0.08
    # compression (used by teas/teaq/teastatic/teasq)
    p_s: float = 1.0
    p_q: int = 32
    schedule: Optional[CompressionSchedule] = None
    codec: str = "dense"
    # per-device adaptive codec policy (repro_torch.fl.policies.POLICIES)
    codec_policy: str = "static"
    tier_points: Optional[List[Tuple[float, int]]] = None
    # latency model
    wireless: WirelessConfig = dataclasses.field(default_factory=WirelessConfig)
    compute: ComputeConfig = dataclasses.field(default_factory=ComputeConfig)
    # fedavg / fedasync
    devices_per_round: int = 10
    max_staleness: int = 4
    seed: int = 0
    # engine-only knobs
    scheduler: str = "heap"
    cohort_size: int = 0
    cohort_channel_iters: int = 12   # threshold binary-search iterations
    handler_mode: str = "serial"     # "serial" | "wave" (batched only)
    server: str = "single"           # repro_torch.core.server.SERVERS backend
    server_shards: int = 0           # sharded-server mesh width (0 = all)
    scenario: Optional[ScenarioConfig] = None


@dataclasses.dataclass
class LogEntry:
    time: float
    round: int
    accuracy: float
    bytes_up: int
    bytes_down: int
    max_model_bytes_up: int
    max_model_bytes_down: int
