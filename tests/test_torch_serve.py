"""The port's serving front door (``repro_torch.launch.serve``), on the CPU.

Greedy ``generate`` of the port against the JAX package's ``generate`` on
the same weights (Mamba2-370M's smoke config, the JAX package's weights
carried across), and the port's ``ContinuousBatcher`` against solo
``generate`` within the port: every request's greedy tokens must equal its
solo decode, including requests admitted mid-flight into a slot another
request just freed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.launch.serve import generate as jax_generate
from repro.models import transformer as JT
from repro_torch.configs.base import get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.serve import ContinuousBatcher, generate
from repro_torch.utils.tree import from_numpy

from torch_threads import one_torch_thread  # noqa: F401

P_LEN, GEN = 8, 6


@pytest.fixture(scope="module")
def lm():
    """(port params, cfg, JAX params, JAX cfg, prompts, solo tokens)."""
    cfg = get_smoke_config("mamba2-370m")
    jcfg = jax_smoke_config("mamba2_370m")
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, P_LEN).astype(np.int32)
               for _ in range(5)]
    solo = [generate(params, cfg, p[None], GEN)[0, P_LEN:].tolist()
            for p in prompts]
    return params, cfg, jparams, jcfg, prompts, solo


# ----------------------------------------------------------------------
# generate against the JAX package
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 8), (1, 64), (2, 128)])
def test_greedy_generate_matches_jax(lm, shape):
    """One, two and several chunks of prompt; batched rows."""
    params, cfg, jparams, jcfg, _, _ = lm
    prompts = np.random.RandomState(shape[1]).randint(
        0, cfg.vocab, shape).astype(np.int32)
    want = np.asarray(jax_generate(jparams, jcfg, jnp.asarray(prompts), 8))
    got = generate(params, cfg, prompts, 8)
    assert got.dtype == torch.int32 and got.shape == (shape[0],
                                                      shape[1] + 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_temperature_sampling_follows_its_generator(lm):
    params, cfg, _, _, prompts, _ = lm
    runs = [generate(params, cfg, prompts[0][None], GEN, temperature=1.0,
                     generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    toks = runs[0][0, P_LEN:]
    assert bool(((toks >= 0) & (toks < cfg.vocab)).all())


# ----------------------------------------------------------------------
# continuous batching
# ----------------------------------------------------------------------
def test_batcher_matches_solo_generate(lm):
    """5 requests through 2 slots: every request's greedy tokens equal its
    solo decode -- including the ones admitted only after earlier
    requests freed a slot."""
    params, cfg, _, _, prompts, solo = lm
    cb = ContinuousBatcher(params, cfg, slots=2, cache_len=P_LEN + GEN)
    outs, lat = cb.run(prompts, GEN)
    assert outs == solo
    assert len(lat) == len(prompts) and all(t > 0 for t in lat)
    # 5 requests over 2 slots need at least ceil(5/2) * (GEN-1) decode
    # steps; well under the serial 5 * (GEN-1) (the point of batching)
    assert cb.steps < 5 * (GEN - 1)


def test_mid_flight_admission_decodes_solo_tokens(lm):
    """A request admitted while another is mid-decode still produces its
    solo tokens, and the resident request is undisturbed."""
    params, cfg, _, _, prompts, solo = lm
    cb = ContinuousBatcher(params, cfg, slots=2, cache_len=P_LEN + GEN)
    r0 = cb.submit(prompts[0], GEN)
    for _ in range(3):                    # r0 is now mid-flight
        cb.step()
    r1 = cb.submit(prompts[1], GEN)
    while cb.pending():
        cb.step()
    assert cb.result(r0) == solo[0]
    assert cb.result(r1) == solo[1]


def test_gen_one_completes_at_admission(lm):
    params, cfg, _, _, prompts, solo = lm
    cb = ContinuousBatcher(params, cfg, slots=2, cache_len=P_LEN + GEN)
    outs, _ = cb.run(prompts[:3], 1)
    assert outs == [s[:1] for s in solo[:3]]
    assert cb.steps == 0


def test_submit_validates(lm):
    params, cfg, _, _, prompts, _ = lm
    cb = ContinuousBatcher(params, cfg, slots=2, cache_len=P_LEN + GEN)
    with pytest.raises(ValueError, match="gen"):
        cb.submit(prompts[0], 0)
    with pytest.raises(ValueError, match="cache_len"):
        cb.submit(prompts[0], GEN + 1)
    assert not cb.pending()


def test_main_serves_on_cpu_and_from_sim_waits(capsys, tmp_path):
    """``main`` serves random weights, and with ``--from-sim`` the weights
    of a simulator checkpoint blob (an engine blob's ``core.server.w``
    leaves, in pytree order) through the continuous batcher; a task with
    no transformer config is refused, as in the JAX package."""
    serve.main(["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--gen", "3",
                "--requests", "3"])
    out = capsys.readouterr().out
    assert "mamba2-370m/smoke on cpu" in out
    assert "continuous batching: 3 requests" in out
    from repro_torch.checkpoint.io import save_blob
    from repro_torch.fl.tasks import get_task
    from repro_torch.utils.tree import leaves
    task = get_task("ssm_lm")
    w = task.init_params(torch.Generator().manual_seed(5), "cpu")
    path = str(tmp_path / "engine.msgpack")
    save_blob(path, {"core": {"server": {"w": [
        v.numpy() for v in leaves(w)]}}})
    serve.main(["--from-sim", path, "--task", "ssm_lm", "--device", "cpu",
                "--batch", "2", "--requests", "3", "--prompt-len", "8",
                "--gen", "4"])
    out = capsys.readouterr().out
    assert "fl-ssm-lm from" in out and "3 requests x gen=4" in out
    params, cfg = serve.load_task_params(path, "ssm_lm", device="cpu")
    assert cfg is task.model_cfg
    assert all(torch.equal(a, b) for a, b in zip(leaves(params), leaves(w)))
    with pytest.raises(ValueError, match="not an LM family"):
        serve.load_task_params(path, "fmnist_cnn", device="cpu")
