"""The port's mesh slice over ``torch.distributed`` against the JAX
package's 2x2 mesh, on the CPU.

One module fixture makes the weights (the port's ``init_model`` from a
seed, as numpy), then runs beside each other:

* the reference on 4 host devices in one subprocess, its mesh built as
  ``jax.make_mesh((2, 2), ("data", "model"), axis_types=(Auto, Auto))``
  (under jax 0.9 the default ``Explicit`` axes make its own mesh scripts
  raise, ROADMAP.md); and
* the port in one gloo world of 4 processes (``launch.mesh.spawn_world``,
  a file store under ``tmp_path``), ``make_host_mesh(2, 2)``.

What is held:

* **The federated round** under ``use_rules(Rules(mesh))`` for
  ``phi3_5_moe_42b`` (the reference test's config, its MoE layers on the
  expert-parallel route) and ``smollm_135m``, over ``gather_q`` at p_q 8
  and 4, ``gather_f32`` and ``psum``, ``tp`` and ``dp`` (``dp`` on the
  dense model: the MoE under ``dp`` raises, ROADMAP.md Queue C).  Params
  leaf by leaf: ``gather_q`` within ``tests/torch_fed_rules.py``'s rule
  (the scales and thresholds of each (group, model block) row, from the
  port's own deltas), the f32 schedules within 1e-5; ``local_loss`` and
  ``delta_norm`` within 1e-5 of the JAX *mesh* round; every rank's params
  equal bit for bit; ``p_q = 4`` sends half the level bytes.
* **The EP MoE** at model 2 (in the world) and model 1 (in this process,
  a world of 1 and a JAX 1x1 mesh): ``y``, ``aux`` and the gradient of
  every leaf (router, the rank's block of ``e_gate``/``e_up``/``e_down``,
  the input) within 1e-5, with the tokens replicated (the fed round's
  ``batch=None``); with the tokens over ``data`` (the outer rules) ``y``
  and ``aux`` within 1e-5, each data rank holding its batch block.
* **The sequence-sharded decode** on ``granite_34b`` (one KV head): 16
  steps of ``decode_step(seq_shard_kv=True)``, each rank holding its
  batch rows and its half of the cache: logits within 1e-5 of the JAX
  seqshard run and within the reference's 5e-4 of the full forward.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro.sharding.rules import Rules as JRules
from repro.sharding.rules import use_rules as jax_use_rules
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import fed_step as F
from repro_torch.launch.mesh import init_world, make_host_mesh, spawn_world
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.sharding.rules import Rules, use_rules
from repro_torch.utils.tree import from_numpy, leaves, paths

from torch_fed_rules import F32_TOL, assert_gather_q_close
from torch_threads import one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ARCHS = {"moe": "phi3_5_moe_42b", "dense": "smollm_135m",
         "granite": "granite_34b"}
# (model, schedule, p_q, group parallelism)
ROUNDS = [("moe", "gather_q", 8, "tp"), ("moe", "gather_q", 4, "tp"),
          ("dense", "gather_f32", 8, "dp"), ("dense", "psum", 8, "tp"),
          ("dense", "gather_q", 8, "dp")]
TOL = 1e-5

COMMON = r"""
import numpy as np
ARCHS = %r
ROUNDS = %r
def nested(flat, prefix):
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        keys = key[len(prefix):].split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out
TOKENS = np.random.RandomState(0).randint(0, 1 << 30, (4, 32))
STALE = [0, 2]
""" % (ARCHS, ROUNDS)

JAX_SCRIPT = COMMON + r"""
import sys
import jax, jax.numpy as jnp
from repro.configs.base import get_smoke_config
from repro.core.fed_step import FedConfig, make_fed_train_step
from repro.models import moe as M
from repro.models import transformer as T
from repro.sharding.rules import Rules, use_rules
flat = dict(np.load(sys.argv[1]))
out = {}
def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
rules = Rules(mesh)
cfgs = {k: get_smoke_config(a) for k, a in ARCHS.items()}
params = {k: jax.tree.map(jnp.asarray, nested(flat, k + "/")) for k in ARCHS}
for model, sched, pq, gp in ROUNDS:
    cfg = cfgs[model]
    batch = {"tokens": jnp.asarray(TOKENS % cfg.vocab, jnp.int32)}
    fed = FedConfig(n_groups=2, local_steps=1, lr=1e-2, schedule=sched,
                    p_q=pq, group_parallelism=gp)
    step = make_fed_train_step(lambda p, b: T.lm_loss(p, b, cfg)[0], fed)
    with use_rules(rules), mesh:
        p, m = jax.jit(step)(params[model], batch,
                             jnp.asarray(STALE, jnp.int32))
    name = f"{model}-{sched}-{pq}-{gp}"
    put(f"round/{name}/", p)
    out[f"loss/{name}"] = np.asarray(m["local_loss"])
    out[f"dnorm/{name}"] = np.asarray(m["delta_norm"])
# the EP MoE at model 2: one MoE layer of the MoE model
cfg = cfgs["moe"]
mp = jax.tree.map(lambda a: a[0], params["moe"]["layers"]["moe"])
x, c = jnp.asarray(flat["ep/x"]), jnp.asarray(flat["ep/c"])
def loss(p, x):
    y, aux = M.moe_apply(p, x, cfg)
    return jnp.sum(y * c) + 0.5 * aux, (y, aux)
with use_rules(rules.with_overrides(batch=None)), mesh:
    (_, (y, aux)), g = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(mp, x)
out["ep/y"], out["ep/aux"] = np.asarray(y), np.asarray(aux)
put("ep/gp/", g[0])
out["ep/gx"] = np.asarray(g[1])
with use_rules(rules), mesh:
    y, aux = jax.jit(lambda p, x: M.moe_apply(p, x, cfg))(mp, x)
out["ep_data/y"], out["ep_data/aux"] = np.asarray(y), np.asarray(aux)
# the sequence-sharded decode
cfg = cfgs["granite"]
toks = jnp.asarray(flat["seq/toks"], jnp.int32)
full, _ = T.forward(params["granite"], {"tokens": toks}, cfg)
out["seq/full"] = np.asarray(full)
cache = T.init_decode_state(cfg, 4, toks.shape[1], dtype=jnp.float32)
logits = []
with use_rules(rules), mesh:
    step = jax.jit(lambda p, t, pos, c: T.decode_step(
        p, t, pos, cfg, c, seq_shard_kv=True))
    for t in range(toks.shape[1]):
        dl, cache = step(params["granite"], toks[:, t:t + 1], jnp.int32(t),
                         cache)
        logits.append(np.asarray(dl[:, 0]))
out["seq/logits"] = np.stack(logits)
np.savez(sys.argv[2], **out)
"""

WORLD_SCRIPT = COMMON + r"""
import os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import fed_step as F
from repro_torch.core.compression import approx_topk_threshold_rows
from repro_torch.launch.mesh import init_world, make_host_mesh
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.sharding.rules import (Rules, axis_index, local_block,
                                        logical_axes_for, use_rules)
from repro_torch.utils.tree import from_numpy, leaves, paths, tree_map
init_world("gloo")
rank = dist.get_rank()
mesh = make_host_mesh(2, 2)
rules = Rules(mesh)
d, _ = axis_index(mesh, "data")
m, _ = axis_index(mesh, "model")
flat = dict(np.load(sys.argv[1]))
out = {}
cfgs = {k: get_smoke_config(a) for k, a in ARCHS.items()}
params = {k: from_numpy(nested(flat, k + "/"), "cpu") for k in ARCHS}
stale = torch.tensor(STALE)


def block_stats(loss, fed, w, batch):
    # per leaf the largest scale and threshold of a (group, block) row,
    # from this rank's deltas, the largest over the world
    G = fed.n_groups
    gb = tree_map(lambda x: x.reshape((G, 1, x.shape[0] // G)
                                      + x.shape[1:])[d:d + 1], batch)
    local = torch.func.vmap(lambda b: F._group_local_train(w, b, loss, fed))
    with use_rules(F._local_rules(rules, fed)):
        wl, _ = local(gb)
    stats = []
    for name, a, w0 in zip(paths(w), leaves(wl), leaves(w)):
        spec = rules.spec(logical_axes_for("/".join(name), w0.dim()),
                          w0.shape)
        rows = local_block(a - w0[None], (None,) + spec, mesh).reshape(1, -1)
        sc = max(float(F.compress_delta(r, fed)[1]) for r in rows)
        thr = float(approx_topk_threshold_rows(
            rows.abs(), fed.p_s, fed.threshold_iters).max())
        stats.append((sc, thr))
    t = torch.tensor(stats)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.numpy()


for model, sched, pq, gp in ROUNDS:
    cfg = cfgs[model]
    batch = {"tokens": torch.from_numpy(TOKENS % cfg.vocab)}
    fed = F.FedConfig(n_groups=2, local_steps=1, lr=1e-2, schedule=sched,
                      p_q=pq, group_parallelism=gp)
    loss = lambda p, b, cfg=cfg: T.lm_loss(p, b, cfg)[0]
    with use_rules(rules):
        p, met = F.make_fed_train_step(loss, fed)(params[model], batch,
                                                  stale)
    name = f"{model}-{sched}-{pq}-{gp}"
    for i, leaf in enumerate(leaves(p)):
        out[f"round/{name}/{i}"] = leaf.numpy()
    for k in ("local_loss", "delta_norm", "alpha_t"):
        out[f"{k}/{name}"] = np.asarray(float(met[k]))
    out[f"wire/{name}"] = np.asarray(met.get("wire_bytes", 0))
    if sched == "gather_q":
        out[f"stats/{name}"] = block_stats(loss, fed, params[model], batch)
# G must split over the fed axes
try:
    with use_rules(rules):
        F.make_fed_train_step(lambda p, b: T.lm_loss(p, b, cfgs["dense"])[0],
                              F.FedConfig(n_groups=3))(
            params["dense"], {"tokens": torch.from_numpy(
                TOKENS[:3] % cfgs["dense"].vocab)}, torch.zeros(3))
    out["g_error"] = np.asarray(0)
except ValueError:
    out["g_error"] = np.asarray(1)
# the EP MoE at model 2
cfg = cfgs["moe"]
mp = {k: v[0].clone().requires_grad_(True)
      for k, v in params["moe"]["layers"]["moe"].items()}
x = torch.from_numpy(flat["ep/x"]).requires_grad_(True)
c = torch.from_numpy(flat["ep/c"])
with use_rules(rules.with_overrides(batch=None)):
    y, aux = M.moe_apply(mp, x, cfg)
(torch.sum(y * c) + 0.5 * aux).backward()
out["ep/y"], out["ep/aux"] = y.detach().numpy(), aux.detach().numpy()
for k, v in mp.items():
    out[f"ep/gp/{k}"] = v.grad.numpy()
out["ep/gx"] = x.grad.numpy()
with torch.no_grad(), use_rules(rules):
    y, aux = M.moe_apply(mp, x[d:d + 1], cfg)      # this rank's batch row
out["ep_data/y"], out["ep_data/aux"] = y.numpy(), aux.numpy()
# the sequence-sharded decode: batch rows over data, the cache over model
cfg = cfgs["granite"]
toks = torch.from_numpy(flat["seq/toks"])[2 * d:2 * d + 2]
S = toks.shape[1]
cache = T.init_decode_state(cfg, 2, S // 2, dtype=torch.float32,
                            device="cpu")
logits = []
with torch.no_grad(), use_rules(rules):
    for t in range(S):
        dl, cache = T.decode_step(params["granite"], toks[:, t:t + 1], t,
                                  cfg, cache, seq_shard_kv=True)
        logits.append(dl[:, 0].numpy())
out["seq/logits"] = np.stack(logits)
np.savez(os.path.join(sys.argv[2], f"rank{rank}.npz"), **out)
dist.destroy_process_group()
"""


def _flat(prefix, tree):
    return {prefix + "/".join(p): x.numpy()
            for p, x in zip(paths(tree), leaves(tree))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(weights and inputs, the reference's outputs, each rank's
    outputs)."""
    tmp = tmp_path_factory.mktemp("mesh")
    flat = {}
    for i, (k, arch) in enumerate(ARCHS.items()):
        cfg = get_smoke_config(arch)
        flat.update(_flat(k + "/", T.init_model(
            cfg, torch.Generator().manual_seed(i), device="cpu")))
    rng = np.random.RandomState(5)
    d = get_smoke_config(ARCHS["moe"]).d_model
    flat["ep/x"] = rng.randn(2, 16, d).astype(np.float32)
    flat["ep/c"] = rng.randn(2, 16, d).astype(np.float32)
    flat["seq/toks"] = np.random.RandomState(1).randint(
        0, get_smoke_config(ARCHS["granite"]).vocab, (4, 16))
    np.savez(tmp / "in.npz", **flat)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    ref = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT,
                            str(tmp / "in.npz"), str(tmp / "ref.npz")],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        spawn_world([sys.executable, "-c", WORLD_SCRIPT, str(tmp / "in.npz"),
                     str(tmp)], 4, timeout=600,
                    env={**os.environ, "PYTHONPATH": SRC},
                    store_dir=str(tmp))
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, out + err
    return (flat, dict(np.load(tmp / "ref.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)])


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("case", ROUNDS, ids=["-".join(map(str, c))
                                               for c in ROUNDS])
def test_mesh_round_matches_jax(runs, case):
    flat, ref, ranks = runs
    model, sched, pq, gp = case
    name = f"{model}-{sched}-{pq}-{gp}"
    keys = [k for k in flat if k.startswith(model + "/")]
    order = sorted(keys, key=lambda k: k.split("/"))   # jax.tree.leaves
    want = [ref[f"round/{name}/" + k[len(model) + 1:]] for k in order]
    got = [ranks[0][f"round/{name}/{i}"] for i in range(len(want))]
    if sched == "gather_q":
        assert_gather_q_close(got, want, ranks[0][f"stats/{name}"], pq)
    else:
        for g, w in zip(got, want):
            _close(g, w, F32_TOL)
    assert abs(float(ranks[0][f"local_loss/{name}"])
               - float(ref[f"loss/{name}"])) <= TOL
    assert abs(float(ranks[0][f"delta_norm/{name}"])
               - float(ref[f"dnorm/{name}"])) <= TOL
    for r in ranks[1:]:
        for i in range(len(want)):
            np.testing.assert_array_equal(r[f"round/{name}/{i}"],
                                          got[i])
        assert float(r[f"local_loss/{name}"]) == \
            float(ranks[0][f"local_loss/{name}"])


def test_int4_wire_halves_the_level_bytes(runs):
    """At p_q = 4 the levels go two a byte: the bytes a rank sends are
    half of p_q = 8's, but for the f32 scales (one per leaf row)."""
    _, _, ranks = runs
    w8 = int(ranks[0]["wire/moe-gather_q-8-tp"])
    w4 = int(ranks[0]["wire/moe-gather_q-4-tp"])
    scales = 4 * len(ranks[0]["stats/moe-gather_q-8-tp"])  # a group a rank
    assert w4 - scales == -(-(w8 - scales) // 2)


def test_groups_must_split_over_the_fed_axes(runs):
    assert all(int(r["g_error"]) == 1 for r in runs[2])


def _block(key, a, m, n_model=2):
    if key.split("/")[-1] in ("e_gate", "e_up", "e_down"):
        e = a.shape[0] // n_model
        return a[m * e:(m + 1) * e]
    return a


def test_ep_moe_model_2_matches_jax(runs):
    """Tokens replicated (the fed round's ``batch=None``): y, aux and the
    gradient of every leaf, each rank's expert block against the
    reference's same block."""
    _, ref, ranks = runs
    for r, got in enumerate(ranks):
        m = r % 2
        _close(got["ep/y"], ref["ep/y"])
        _close(got["ep/aux"], ref["ep/aux"])
        _close(got["ep/gx"], ref["ep/gx"])
        for k in ("router", "e_gate", "e_up", "e_down"):
            _close(_block(k, got[f"ep/gp/{k}"], m),
                   _block(k, ref[f"ep/gp/{k}"], m))


def test_ep_moe_tokens_over_data_match_jax(runs):
    """The outer rules: each data rank's batch row through its experts,
    aux averaged over ``data``."""
    _, ref, ranks = runs
    for r, got in enumerate(ranks):
        d = r // 2
        _close(got["ep_data/y"], ref["ep_data/y"][d:d + 1])
        _close(got["ep_data/aux"], ref["ep_data/aux"])


def test_seqshard_decode_matches_jax(runs):
    _, ref, ranks = runs
    for r, got in enumerate(ranks):
        d = r // 2
        want = ref["seq/logits"][:, 2 * d:2 * d + 2]
        _close(got["seq/logits"], want)
        full = np.moveaxis(ref["seq/full"][2 * d:2 * d + 2], 1, 0)
        assert float(np.abs(got["seq/logits"] - full).max()) < 5e-4


# ----------------------------------------------------------------------
# in this process: a world of 1 and the JAX package's 1x1 mesh
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def world_of_one():
    import torch.distributed as dist
    init_world("gloo")
    try:
        yield make_host_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_ep_moe_model_1_matches_jax(world_of_one):
    """At model 1 every expert is the rank's: the EP route (capacity
    drops included) against the reference's on a 1x1 mesh."""
    cfg = get_smoke_config(ARCHS["moe"])
    w = T.init_model(cfg, torch.Generator().manual_seed(3), device="cpu")
    mp = {k: v[0] for k, v in w["layers"]["moe"].items()}
    rng = np.random.RandomState(8)
    x = rng.randn(2, 16, cfg.d_model).astype(np.float32)
    c = rng.randn(2, 16, cfg.d_model).astype(np.float32)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    from repro.configs.base import get_smoke_config as jax_smoke_config
    jcfg = jax_smoke_config(ARCHS["moe"])

    def jloss(p, x):
        y, aux = JM.moe_apply(p, x, jcfg)
        return jnp.sum(y * c) + 0.5 * aux, (y, aux)

    with jax_use_rules(JRules(jmesh)), jmesh:
        (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(
            {k: jnp.asarray(v.numpy()) for k, v in mp.items()},
            jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in mp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    with use_rules(Rules(world_of_one)):
        y, aux = M.moe_apply(tp, tx, cfg)
    (torch.sum(y * torch.from_numpy(c)) + 0.5 * aux).backward()
    _close(y.detach().numpy(), jy)
    _close(aux.detach().numpy(), jaux)
    _close(tx.grad.numpy(), jgx)
    for k, v in tp.items():
        _close(v.grad.numpy(), jgp[k])
    # the dense route (no rules) differs where capacity drops slots
    y_dense, _ = M.moe_apply(mp, torch.from_numpy(x), cfg)
    assert y_dense.shape == y.shape


def test_moe_under_dp_raises(world_of_one):
    """The reference's dp rules shard the tokens over the experts' own
    axis (ROADMAP.md Queue C): the port refuses."""
    cfg = get_smoke_config(ARCHS["moe"])
    w = T.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = F.make_fed_train_step(lambda p, b: T.lm_loss(p, b, cfg)[0],
                                 F.FedConfig(n_groups=2,
                                             group_parallelism="dp"))
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 8),
                                     generator=torch.Generator()
                                     .manual_seed(0))}
    with use_rules(Rules(world_of_one)):
        with pytest.raises(ValueError, match="Queue C"):
            step(w, batch, torch.zeros(2))
    with pytest.raises(ValueError, match="group_parallelism"):
        F.make_fed_train_step(lambda p, b: 0.0,
                              F.FedConfig(group_parallelism="ep"))


def test_mesh_round_at_1x1_is_the_unsharded_round(world_of_one):
    """On a (1, 1) mesh the dense model's round is the no-mesh round: the
    same local steps, the same compressor rows (a block is the leaf)."""
    cfg = get_smoke_config(ARCHS["dense"])
    w = T.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.from_numpy(
        np.random.RandomState(0).randint(0, cfg.vocab, (8, 16)))}
    for sched in ("gather_q", "gather_f32", "psum"):
        fed = F.FedConfig(n_groups=4, local_steps=1, lr=1e-2,
                          schedule=sched)
        step = F.make_fed_train_step(lambda p, b: T.lm_loss(p, b, cfg)[0],
                                     fed)
        p0, m0 = step(w, batch, torch.tensor([0, 1, 2, 3]))
        with use_rules(Rules(world_of_one)):
            p1, m1 = step(w, batch, torch.tensor([0, 1, 2, 3]))
        for a, b in zip(leaves(p0), leaves(p1)):
            _close(a.numpy(), b.numpy(), F32_TOL)
        assert abs(float(m0["local_loss"]) - float(m1["local_loss"])) <= TOL
