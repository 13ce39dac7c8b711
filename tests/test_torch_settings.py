"""Settings of ``run_method`` beyond the defaults, pinned against a live
run of the JAX package on the CPU, from the same data, partitions and
weights (8 devices, seed 3, a 4 s budget, one epoch): the Alg. 5 schedule
on the serial path (dense, then packed) and on the cohort path;
heterogeneous tiers on the serial path and, with dropout, on the cohort
path; non-IID partitions for teasq and moon; the ``identity`` codec; and
fedasync on the cohort trainer.

The time, round and byte columns are exact (every draw is numpy in both
packages, in the same order); accuracy within ``ACC_TOL`` absolute per
entry.
"""
import numpy as np
import pytest

from repro.core.dynamic import make_schedule as jax_make_schedule
from repro.fl.protocols import make_setup as jax_make_setup
from repro.fl.protocols import run_method as jax_run_method
from repro.fl.simulator import ScenarioConfig as JScenarioConfig
from repro.fl.simulator import TierSpec as JTierSpec
from repro_torch.core.dynamic import make_schedule
from repro_torch.fl.protocols import make_setup, run_method
from repro_torch.fl.simulator import ScenarioConfig, TierSpec

from conftest import TINY_RUN_KW, TINY_SETUP
from torch_threads import one_torch_thread  # noqa: F401

ACC_TOL = 0.025
COLUMNS = ("time", "round", "bytes_up", "bytes_down", "max_model_bytes_up",
           "max_model_bytes_down")
# (fraction, compute_scale, bandwidth_scale, name)
TIERS = [(0.25, 1.0, 1.0, "fast"), (0.375, 1.5, 0.5, "mid"),
         (0.375, 2.5, 0.125, "slow")]


def _setups(iid):
    jdata, jparts, jw0 = jax_make_setup(**{**TINY_SETUP, "iid": iid})
    port = make_setup(**{**TINY_SETUP, "iid": iid}, device="cpu",
                      init_params={k: np.asarray(v) for k, v in jw0.items()})
    return (jdata, jparts, jw0), port


@pytest.fixture(scope="module")
def iid_setups():
    return _setups(True)


def _kw(setting):
    """The run's keywords for the JAX package and for the port."""
    jkw, tkw = {}, {}
    if "schedule" in setting:
        jkw["schedule"] = jax_make_schedule(4, 3, 2)
        tkw["schedule"] = make_schedule(4, 3, 2)
    if "tiers" in setting:
        drop = 0.1 if "dropout" in setting else 0.0
        jkw["scenario"] = JScenarioConfig(
            dropout_prob=drop, tiers=[JTierSpec(*t) for t in TIERS])
        tkw["scenario"] = ScenarioConfig(
            dropout_prob=drop, tiers=[TierSpec(*t) for t in TIERS])
    return jkw, tkw


SETTINGS = [
    ("teasq", ("schedule",), dict(codec="dense")),
    ("teasq", ("schedule",), dict(codec="packed")),
    ("teasq", ("schedule",), dict(cohort_size=4)),
    ("teasq", ("tiers",), dict()),
    ("teasq", ("tiers", "dropout"), dict(cohort_size=4)),
    ("teasq", (), dict(codec="identity")),
    ("fedasync", (), dict(cohort_size=4)),
]


def _assert_parity(h_jax, h_port):
    assert len(h_jax) == len(h_port) > 2
    for a, b in zip(h_jax, h_port):
        for c in COLUMNS:
            assert getattr(a, c) == getattr(b, c), c
        assert abs(a.accuracy - b.accuracy) <= ACC_TOL


@pytest.mark.parametrize(
    "method,setting,extra", SETTINGS,
    ids=["schedule_dense", "schedule_packed", "schedule_cohort",
         "tiers_serial", "tiers_dropout_cohort", "identity",
         "fedasync_cohort"])
def test_setting_matches_live_jax(iid_setups, method, setting, extra):
    (jdata, jparts, jw0), (data, parts, w0) = iid_setups
    jkw, tkw = _kw(setting)
    kw = dict(TINY_RUN_KW, p_s=0.25, p_q=8, **extra)
    h_jax = jax_run_method(method, jdata, jparts, jw0, **kw, **jkw)
    h_port = run_method(method, data, parts, w0, device="cpu", **kw, **tkw)
    _assert_parity(h_jax, h_port)


@pytest.mark.parametrize("method", ["teasq", "moon"])
def test_non_iid_partitions_match_live_jax(method):
    """The paper's label-skew partitions (2 classes per device)."""
    (jdata, jparts, jw0), (data, parts, w0) = _setups(False)
    kw = dict(TINY_RUN_KW, p_s=0.25, p_q=8, iid=False)
    h_jax = jax_run_method(method, jdata, jparts, jw0, **kw)
    h_port = run_method(method, data, parts, w0, device="cpu", **kw)
    _assert_parity(h_jax, h_port)
