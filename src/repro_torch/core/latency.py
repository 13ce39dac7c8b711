"""Latency model (paper §3.1 + §5.1 wireless setup).

Communication: devices uniform in a disk of radius R around the base
station; max rate r = B log2(1 + P h^2 / (B N0)) with path-loss exponent
alpha_pl.  Computation: shifted exponential (Eq. 2):
  P[L < l] = 1 - exp(-(phi_k / (tau b)) (l - a_k tau b)),  l >= a_k tau b.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class WirelessConfig:
    radius_m: float = 600.0
    # per-device OFDMA share: ~10 concurrent devices split the 20 MHz cell
    # (the paper's C-fraction keeps ~N*C=10 devices transmitting)
    bandwidth_hz: float = 2e6
    pathloss_exp: float = 3.76
    p_server_dbm: float = 20.0
    p_device_dbm: float = 10.0
    noise_dbm_per_mhz: float = -114.0


def _dbm_to_w(dbm: float) -> float:
    return 10 ** (dbm / 10.0) / 1000.0


def device_rates(n_devices: int, cfg: WirelessConfig,
                 rng: np.random.RandomState):
    """Sample device positions; return (down_rates, up_rates) in bits/s."""
    # uniform in disk
    r = cfg.radius_m * np.sqrt(rng.random_sample(n_devices))
    d = np.maximum(r, 1.0)
    gain = d ** (-cfg.pathloss_exp)                  # h^2 (path loss only)
    n0_w = _dbm_to_w(cfg.noise_dbm_per_mhz) * (cfg.bandwidth_hz / 1e6)
    snr_down = _dbm_to_w(cfg.p_server_dbm) * gain / n0_w
    snr_up = _dbm_to_w(cfg.p_device_dbm) * gain / n0_w
    down = cfg.bandwidth_hz * np.log2(1.0 + snr_down)
    up = cfg.bandwidth_hz * np.log2(1.0 + snr_up)
    return down, up


@dataclasses.dataclass
class ComputeConfig:
    """Shifted-exponential per-device compute latency (Eq. 2)."""
    a_min: float = 0.3      # per-unit-work shift coefficient range
    a_max: float = 2.0      # (heterogeneous device speeds, ~6x spread)
    phi: float = 3.0        # fluctuation (higher = less noise)


def sample_compute_latency(a_k: float, phi_k: float, tau_b: float,
                           rng: np.random.RandomState) -> float:
    """One draw of L^cp: shift a_k*tau_b plus Exp(phi_k / tau_b)."""
    shift = a_k * tau_b
    return shift + rng.exponential(tau_b / phi_k)


def comm_latency(bits: float, rate_bps: float) -> float:
    return bits / max(rate_bps, 1.0)


# ----------------------------------------------------------------------
# Vectorized (wave) variants.
#
# RNG draw-order contract: ``sample_compute_latency_batch`` consumes the
# generator with ONE ``rng.exponential(size=G)`` call, i.e. exactly the
# stream positions G sequential scalar draws would use, with value i
# going to position i of the input arrays.  Wave callers pass the arrays
# in ascending device-index order (the documented relaxed-parity order of
# ``SimConfig.handler_mode="wave"``), so draw i belongs to the i-th
# lowest device id of the wave — not to the i-th heap pop.
# ----------------------------------------------------------------------
def comm_latency_batch(bits, rate_bps: np.ndarray) -> np.ndarray:
    """Elementwise ``comm_latency`` — same float64 ops, no RNG."""
    return np.asarray(bits, dtype=np.float64) / np.maximum(rate_bps, 1.0)


def sample_compute_latency_batch(a_k: np.ndarray, phi_k: np.ndarray,
                                 tau_b: np.ndarray,
                                 rng: np.random.RandomState) -> np.ndarray:
    """G draws of L^cp in one call (see draw-order contract above)."""
    tau_b = np.asarray(tau_b, dtype=np.float64)
    return a_k * tau_b + rng.exponential(tau_b / phi_k)
