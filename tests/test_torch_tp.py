"""Megatron tensor parallelism in the port against the JAX package's mesh
runs, on the CPU.

Under active rules each rank holds its block of every parameter, as
``Rules.spec`` cuts it (``sharding/rules.py::param_blocks``), and computes
its share of each layer on it.  One module fixture makes the weights (the
port's ``init_model`` from a seed, as numpy) and runs beside each other:

* the reference on 4 host devices in three subprocesses (each mesh's
  forwards and gradients, and the rounds and the decode), its meshes
  built with ``Auto`` axes (jax 0.9's default ``Explicit`` axes make its
  own mesh scripts raise, ROADMAP.md); and
* the port in one gloo world of 4 processes (``launch.mesh.spawn_world``),
  on the meshes (2, 2) and (1, 4).  Every rank is in every mesh (a subset
  mesh hangs the next group).

The configs cover the head-alignment cases of the rules' blocks:
``qwen3_1_7b`` (whole heads at model 2, kv cut through a head at 4,
qk-norm, a tied vocabulary), ``smollm_135m`` (q cut through a head:
the attention gathered whole), ``granite_34b`` (MQA), ``phi3_5_moe_42b``
(attention TP beside the expert-parallel experts), ``jamba_v0_1_52b``
(the hybrid: its attention and its head-split Mamba2 mixers),
``whisper_tiny`` (cross attention; its vocabulary set to 515, which
divides neither 2 nor 4, as the full config's 51,865 does not divide 16)
and ``mamba2_370m`` (8 heads: 4 a rank at (2, 2), 2 at (1, 4)).  The
MoE configs take ``capacity_factor`` 8, so that no slot drops and the
port's unsharded (dense) route computes the same function.

What is held:

* ``forward`` logits within 1e-5 of the reference's mesh forward and of
  the port's unsharded forward (each data rank its batch rows);
* each rank's gradient of ``lm_loss`` (``remat``, ``loss_chunk`` 5) for
  its block, within 1e-5 of the leaf's largest value, against that block
  of the reference's ``jax.grad`` (the tokens replicated over the mesh);
* the (2, 2) federated round of ``qwen3_1_7b`` on the blocks under
  ``gather_q``, ``gather_f32`` and ``psum`` (``tp``) and ``gather_q`` and
  ``psum`` (``dp``), and of ``mamba2_370m`` under ``gather_q`` and
  ``psum`` (``tp``: the head-split mixer), gathered whole: ``gather_q``
  by ``tests/torch_fed_rules.py``'s rule, the f32 schedules within 1e-5,
  the metrics within 1e-5, and the blocks cut as the rules cut them;
* 8 greedy decode steps at (2, 2) of ``qwen3_1_7b`` (the cache on the
  rank's kv heads) and of ``mamba2_370m`` and ``jamba_v0_1_52b`` (the
  SSM state on the rank's heads): tokens equal to the reference's,
  logits and each rank's block of the state within 1e-5;
* one Mamba2 mixer at (1, 4): whole, bit for bit, where its heads do not
  divide the axis, and reading nothing of another rank's heads where
  they do.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.launch.mesh import spawn_world
from repro_torch.models import transformer as T
from repro_torch.utils.tree import leaves, paths

from torch_fed_rules import F32_TOL, assert_gather_q_close
from torch_threads import one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ARCHS = ["qwen3_1_7b", "smollm_135m", "granite_34b", "phi3_5_moe_42b",
         "jamba_v0_1_52b", "whisper_tiny", "mamba2_370m"]
MESHES = [(2, 2), (1, 4)]
# (arch, schedule, group parallelism) of the (2, 2) rounds
ROUNDS = [("qwen3_1_7b", "gather_q", "tp"), ("qwen3_1_7b", "gather_f32", "tp"),
          ("qwen3_1_7b", "psum", "tp"), ("qwen3_1_7b", "gather_q", "dp"),
          ("qwen3_1_7b", "psum", "dp"), ("mamba2_370m", "gather_q", "tp"),
          ("mamba2_370m", "psum", "tp")]
# the greedy decodes at (2, 2)
DECODES = ["qwen3_1_7b", "mamba2_370m", "jamba_v0_1_52b"]
TOL = 1e-5

COMMON = r"""
import dataclasses
import numpy as np
ARCHS = %r
MESHES = %r
ROUNDS = %r
DECODES = %r
def config(get, arch):
    cfg = get(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    if arch == "whisper_tiny":
        cfg = dataclasses.replace(cfg, vocab=515)
    return cfg
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
def batch_of(flat, arch, cfg):
    b = {"tokens": flat["tok"] %% cfg.vocab}
    if cfg.is_encoder_decoder:
        b["frames"] = flat["frames/" + arch]
    return b
ROUND_TOKENS = np.random.RandomState(7).randint(0, 1 << 30, (4, 16))
STALE = [0, 2]
GEN = 8
def ssm_state(cache):
    # the SSM state of a decode cache: the uniform stack's, or the
    # hybrid's under its "ssm" key; None for an attention stack
    cache = cache.get("ssm", cache)
    return cache.get("state")
""" % (ARCHS, MESHES, ROUNDS, DECODES)

JAX_SCRIPT = COMMON + r"""
import sys
import jax, jax.numpy as jnp
from repro.configs.base import get_smoke_config
from repro.core.fed_step import FedConfig, make_fed_train_step
from repro.models import transformer as T
from repro.sharding.rules import Rules, use_rules
flat = dict(np.load(sys.argv[1]))
part = sys.argv[3]        # a mesh's forwards and gradients, or "rounds"
out = {}
def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
for shape in MESHES:
    tag = "%dx%d" % shape
    if part != tag:
        continue
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = Rules(mesh)
    for arch in ARCHS:
        cfg = config(get_smoke_config, arch)
        params = jax.tree.map(jnp.asarray, nested(flat, arch + "/"))
        batch = jax.tree.map(jnp.asarray, batch_of(flat, arch, cfg))
        with use_rules(rules), mesh:
            logits = jax.jit(lambda p, b: T.forward(p, b, cfg)[0])(
                params, batch)
        out[f"fwd/{tag}/{arch}"] = np.asarray(logits)
        loss = lambda p: T.lm_loss(p, batch, cfg, remat=True,
                                   loss_chunk=5)[0]
        with use_rules(rules.with_overrides(batch=None)), mesh:
            g = jax.jit(jax.grad(loss))(params)
        put(f"grad/{tag}/{arch}/", g)
if part != "rounds":
    np.savez(sys.argv[2], **out)
    sys.exit()
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
rules = Rules(mesh)
for arch, sched, gp in ROUNDS:
    cfg = config(get_smoke_config, arch)
    params = jax.tree.map(jnp.asarray, nested(flat, arch + "/"))
    batch = {"tokens": jnp.asarray(ROUND_TOKENS % cfg.vocab, jnp.int32)}
    fed = FedConfig(n_groups=2, local_steps=1, lr=1e-2, schedule=sched,
                    group_parallelism=gp)
    step = make_fed_train_step(lambda p, b: T.lm_loss(p, b, cfg)[0], fed)
    with use_rules(rules), mesh:
        p, m = jax.jit(step)(params, batch, jnp.asarray(STALE, jnp.int32))
    name = f"{arch}-{sched}-{gp}"
    put(f"round/{name}/", p)
    out[f"loss/{name}"] = np.asarray(m["local_loss"])
    out[f"dnorm/{name}"] = np.asarray(m["delta_norm"])
# greedy decode
for arch in DECODES:
    cfg = config(get_smoke_config, arch)
    params = jax.tree.map(jnp.asarray, nested(flat, arch + "/"))
    toks = jnp.asarray(flat["tok"] % cfg.vocab, jnp.int32)
    S = toks.shape[1]
    with use_rules(rules), mesh:
        logits, cache = jax.jit(lambda p, b: T.prefill(p, b, cfg))(
            params, {"tokens": toks})
        cache = T.extend_cache(cache, S + GEN)
        step = jax.jit(lambda p, t, pos, c: T.decode_step(p, t, pos, cfg,
                                                          c))
        t = jnp.argmax(logits[:, -1], -1)[:, None]
        got, lg = [t], [logits[:, -1]]
        for i in range(GEN):
            l, cache = step(params, t, jnp.int32(S + i), cache)
            t = jnp.argmax(l[:, -1], -1)[:, None]
            got.append(t)
            lg.append(l[:, -1])
    out[f"dec/{arch}/tokens"] = np.asarray(jnp.concatenate(got, 1))
    out[f"dec/{arch}/logits"] = np.asarray(jnp.stack(lg))
    if ssm_state(cache) is not None:
        out[f"dec/{arch}/state"] = np.asarray(ssm_state(cache))
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
from repro_torch.models import ssm as SM
from repro_torch.models import transformer as T
from repro_torch.sharding.rules import (Rules, axis_index, block_specs,
                                        gather_params, local_block,
                                        param_blocks, use_rules)
from repro_torch.utils.tree import from_numpy, leaves, paths, tree_map
init_world("gloo")
rank = dist.get_rank()
flat = dict(np.load(sys.argv[1]))
out = {}


def starts(blocks, rules):
    # each block's offset in its whole leaf, per dim
    res = []
    for b, spec in zip(leaves(blocks), block_specs(rules, blocks)):
        res.append([axis_index(rules.mesh, ax)[0] * n if ax else 0
                    for ax, n in zip(spec, b.shape)])
    return res


for shape in MESHES:
    mesh = make_host_mesh(*shape)
    rules = Rules(mesh)
    d, n_data = axis_index(mesh, "data")
    tag = "%dx%d" % shape
    for arch in ARCHS:
        cfg = config(get_smoke_config, arch)
        params = from_numpy(nested(flat, arch + "/"), "cpu")
        batch = tree_map(torch.from_numpy, batch_of(flat, arch, cfg))
        rows = 4 // n_data
        mine = tree_map(lambda x: x[d * rows:(d + 1) * rows], batch)
        blocks = param_blocks(params, rules)
        with torch.no_grad():
            with use_rules(rules):
                logits, _ = T.forward(blocks, mine, cfg)
            whole, _ = T.forward(params, mine, cfg)
        out[f"fwd/{tag}/{arch}"] = logits.numpy()
        out[f"plain/{tag}/{arch}"] = whole.numpy()
        loss = lambda p: T.lm_loss(p, batch, cfg, remat=True,
                                   loss_chunk=5)[0]
        tr = rules.with_overrides(batch=None)
        with use_rules(tr):
            g = torch.func.grad(loss)(blocks)
        for i, (x, st) in enumerate(zip(leaves(g), starts(g, tr))):
            out[f"grad/{tag}/{arch}/{i}"] = x.numpy()
            out[f"start/{tag}/{arch}/{i}"] = np.asarray(st, np.int64)

# the (2, 2) rounds
mesh = make_host_mesh(2, 2)
rules = Rules(mesh)
d, _ = axis_index(mesh, "data")
for arch, sched, gp in ROUNDS:
    cfg = config(get_smoke_config, arch)
    params = from_numpy(nested(flat, arch + "/"), "cpu")
    blocks = param_blocks(params, rules)
    batch = {"tokens": torch.from_numpy(ROUND_TOKENS % cfg.vocab)}
    loss = lambda p, b: T.lm_loss(p, b, cfg)[0]
    fed = F.FedConfig(n_groups=2, local_steps=1, lr=1e-2, schedule=sched,
                      group_parallelism=gp)
    with use_rules(rules):        # this rank's group: its two batch rows
        p, met = F.make_fed_train_step(loss, fed)(
            blocks, tree_map(lambda x: x[2 * d:2 * d + 2], batch),
            torch.tensor(STALE))
    name = f"{arch}-{sched}-{gp}"
    out[f"shapes/{name}"] = np.asarray(
        [tuple(a.shape) == tuple(b.shape)
         for a, b in zip(leaves(p), leaves(blocks))])
    for i, leaf in enumerate(leaves(gather_params(p, rules))):
        out[f"round/{name}/{i}"] = leaf.numpy()
    for k in ("local_loss", "delta_norm"):
        out[f"{k}/{name}"] = np.asarray(float(met[k]))
    if sched == "gather_q":
        # per leaf the largest scale and threshold of a (group, block)
        # row of this rank's deltas, the largest over the world
        gb = tree_map(lambda x: x.reshape((2, 1, 2) + x.shape[1:])[d:d + 1],
                      batch)
        start = params if gp == "dp" else blocks
        with use_rules(F._local_rules(rules, fed)):
            wl, _ = torch.func.vmap(lambda b: F._group_local_train(
                start, b, loss, fed))(gb)
        stats = []
        for a, w0, spec in zip(leaves(wl), leaves(start),
                               block_specs(rules, blocks)):
            if gp != "dp":
                spec = (None,) * w0.dim()
            r = local_block(a - w0[None], (None,) + spec, mesh).reshape(1, -1)
            stats.append((float(F.compress_delta(r[0], fed)[1]),
                          float(approx_topk_threshold_rows(
                              r.abs(), fed.p_s, fed.threshold_iters).max())))
        t = torch.tensor(stats)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        out[f"stats/{name}"] = t.numpy()

# greedy decode at (2, 2): the rank's rows, its kv heads or its SSM heads
# in the cache
for arch in DECODES:
    cfg = config(get_smoke_config, arch)
    blocks = param_blocks(from_numpy(nested(flat, arch + "/"), "cpu"), rules)
    toks = torch.from_numpy(flat["tok"] % cfg.vocab)[2 * d:2 * d + 2]
    S = toks.shape[1]
    with torch.no_grad(), use_rules(rules):
        logits, cache = T.prefill(blocks, {"tokens": toks}, cfg)
        if "k" in cache:
            out[f"dec/{arch}/kv_heads"] = np.asarray(cache["k"].shape[3])
        cache = T.extend_cache(cache, S + GEN)
        t = logits[:, -1].argmax(-1)[:, None]
        got, lg = [t], [logits[:, -1]]
        for i in range(GEN):
            l, cache = T.decode_step(blocks, t, S + i, cfg, cache)
            t = l[:, -1].argmax(-1)[:, None]
            got.append(t)
            lg.append(l[:, -1])
    out[f"dec/{arch}/tokens"] = torch.cat(got, 1).numpy()
    out[f"dec/{arch}/logits"] = torch.stack(lg).numpy()
    if ssm_state(cache) is not None:
        out[f"dec/{arch}/state"] = ssm_state(cache).numpy()

# one Mamba2 mixer at (1, 4): the smoke config (8 heads, 2 a rank) and one
# of 6 heads, which do not split 4 ways; the split one also with every
# slice of the leaves that another rank reads set to NaN
mesh = make_host_mesh(1, 4)
rules = Rules(mesh)
r, m = axis_index(mesh, "model")
base = config(get_smoke_config, "mamba2_370m")
for name, cfg in (("split", base),
                  ("odd", dataclasses.replace(base, d_model=192))):
    lp = SM.ssm_init(torch.Generator().manual_seed(5), cfg)
    x = torch.from_numpy(np.random.RandomState(5).randn(
        2, 12, cfg.d_model).astype(np.float32))
    with torch.no_grad():
        want = SM.ssm_forward(lp, x, cfg)
        with use_rules(rules):
            y, c = SM.ssm_forward(lp, x, cfg, return_state=True)
            out[f"mixer/{name}/cache_heads"] = np.asarray(
                SM.init_ssm_cache(cfg, 2)["state"].shape[1])
            yd, cd = SM.ssm_decode(lp, x[:, :1], cfg, c)
            if name == "split":
                di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
                ci, hr = di // m, h // m
                bad = {k: v.clone() for k, v in lp.items()
                       if k != "gate_norm"}
                bad["gate_norm"] = {"scale": lp["gate_norm"]["scale"].clone()}
                mine = lambda t, dim, start, size: t.narrow(
                    dim, start, size).clone()
                for t, dim, start, size in (
                        (bad["in_proj"], 1, 0, di),
                        (bad["in_proj"], 1, di, di),
                        (bad["in_proj"], 1, 2 * di + 2 * n, h),
                        (bad["conv_w"], 1, 0, di), (bad["a_log"], 0, 0, h),
                        (bad["ssm_d"], 0, 0, h), (bad["dt_bias"], 0, 0, h),
                        (bad["out_proj"], 0, 0, di),
                        (bad["gate_norm"]["scale"], 0, 0, di)):
                    k = ci if size == di else hr
                    keep = mine(t, dim, start + r * k, k)
                    t.narrow(dim, start, size).fill_(float("nan"))
                    t.narrow(dim, start + r * k, k).copy_(keep)
                yb, cb = SM.ssm_forward(bad, x, cfg, return_state=True)
                ydb, cdb = SM.ssm_decode(bad, x[:, :1], cfg, c)
                out["mixer/poisoned_equal"] = np.asarray(
                    [torch.equal(yb, y), torch.equal(cb["state"], c["state"]),
                     torch.equal(ydb, yd),
                     torch.equal(cdb["state"], cd["state"])])
    out[f"mixer/{name}/exact"] = np.asarray(torch.equal(y, want))
    out[f"mixer/{name}/err"] = np.asarray(float((y - want).abs().max()))
    out[f"mixer/{name}/state_heads"] = np.asarray(c["state"].shape[1])
np.savez(os.path.join(sys.argv[2], f"rank{rank}.npz"), **out)
dist.destroy_process_group()
"""


def _flat(prefix, tree):
    return {prefix + "/".join(p): x.numpy()
            for p, x in zip(paths(tree), leaves(tree))}


def _config(arch):
    import dataclasses
    cfg = get_smoke_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    if arch == "whisper_tiny":
        cfg = dataclasses.replace(cfg, vocab=515)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(weights and inputs, the reference's outputs, each rank's
    outputs)."""
    tmp = tmp_path_factory.mktemp("tp")
    flat = {}
    rng = np.random.RandomState(3)
    flat["tok"] = rng.randint(0, 1 << 30, (4, 12))
    for i, arch in enumerate(ARCHS):
        cfg = _config(arch)
        flat.update(_flat(arch + "/", T.init_model(
            cfg, torch.Generator().manual_seed(i), device="cpu")))
        if cfg.is_encoder_decoder:
            flat["frames/" + arch] = rng.randn(
                4, cfg.enc_seq, cfg.d_model).astype(np.float32)
    np.savez(tmp / "in.npz", **flat)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    parts = ["%dx%d" % m for m in MESHES] + ["rounds"]
    refs = [subprocess.Popen([sys.executable, "-c", JAX_SCRIPT,
                              str(tmp / "in.npz"), str(tmp / f"{p}.npz"), p],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for p in parts]
    try:
        spawn_world([sys.executable, "-c", WORLD_SCRIPT, str(tmp / "in.npz"),
                     str(tmp)], 4, timeout=600,
                    env={**os.environ, "PYTHONPATH": SRC},
                    store_dir=str(tmp))
        for ref in refs:
            out, err = ref.communicate(timeout=600)
            assert ref.returncode == 0, out + err
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    want = {}
    for p in parts:
        want.update(np.load(tmp / f"{p}.npz"))
    return (flat, want,
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)])


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _order(flat, prefix):
    """The leaf keys of one tree in ``jax.tree.leaves`` order."""
    keys = [k for k in flat if k.startswith(prefix)]
    return sorted(keys, key=lambda k: k.split("/"))


CASES = [(m, a) for m in MESHES for a in ARCHS]
IDS = ["%dx%d-%s" % (m + (a,)) for m, a in CASES]


@pytest.mark.parametrize("mesh,arch", CASES, ids=IDS)
def test_forward_matches_jax_and_unsharded(runs, mesh, arch):
    _, ref, ranks = runs
    tag = "%dx%d" % mesh
    rows = 4 // mesh[0]
    for r, got in enumerate(ranks):
        d = r // mesh[1]
        want = ref[f"fwd/{tag}/{arch}"][d * rows:(d + 1) * rows]
        _close(got[f"fwd/{tag}/{arch}"], want)
        _close(got[f"fwd/{tag}/{arch}"], got[f"plain/{tag}/{arch}"])


@pytest.mark.parametrize("mesh,arch", CASES, ids=IDS)
def test_block_gradients_match_jax(runs, mesh, arch):
    """Each rank's gradient for each of its blocks against that block of
    the reference's whole gradient, within 1e-5 of the leaf's largest
    value; the split leaves' blocks are smaller than the whole."""
    flat, ref, ranks = runs
    tag = "%dx%d" % mesh
    keys = _order(flat, arch + "/")
    split = 0
    for got in ranks:
        for i, key in enumerate(keys):
            want = ref[f"grad/{tag}/{key}"]
            g = got[f"grad/{tag}/{arch}/{i}"]
            st = got[f"start/{tag}/{arch}/{i}"]
            block = want[tuple(slice(s, s + n) for s, n in zip(st, g.shape))]
            assert block.shape == g.shape, key
            split += g.size < want.size
            np.testing.assert_allclose(
                g, block, rtol=0, atol=TOL * float(np.abs(want).max()),
                err_msg=key)
    assert split > 0


ROUND_IDS = ["-".join(c[1:]) if c[0] == "qwen3_1_7b" else "-".join(c)
             for c in ROUNDS]


@pytest.mark.parametrize("case", ROUNDS, ids=ROUND_IDS)
def test_tp_round_matches_jax(runs, case):
    flat, ref, ranks = runs
    name = "-".join(case)
    arch = case[0]
    keys = _order(flat, arch + "/")
    want = [ref[f"round/{name}/" + k[len(arch) + 1:]] for k in keys]
    got = [ranks[0][f"round/{name}/{i}"] for i in range(len(want))]
    if case[1] == "gather_q":
        assert_gather_q_close(got, want, ranks[0][f"stats/{name}"], 8)
    else:
        for g, w in zip(got, want):
            _close(g, w, F32_TOL)
    for k, rk in (("local_loss", "loss"), ("delta_norm", "dnorm")):
        assert abs(float(ranks[0][f"{k}/{name}"])
                   - float(ref[f"{rk}/{name}"])) <= TOL
    for r in ranks:
        assert r[f"shapes/{name}"].all()       # blocks in, blocks out
        for i in range(len(want)):
            np.testing.assert_array_equal(r[f"round/{name}/{i}"], got[i])


def _decode_close(ref, ranks, arch):
    """Each rank's greedy tokens equal to its rows of the reference's,
    its logits within 1e-5."""
    for r, got in enumerate(ranks):
        d = r // 2
        np.testing.assert_array_equal(
            got[f"dec/{arch}/tokens"],
            ref[f"dec/{arch}/tokens"][2 * d:2 * d + 2])
        _close(got[f"dec/{arch}/logits"],
               ref[f"dec/{arch}/logits"][:, 2 * d:2 * d + 2])


def test_greedy_decode_on_local_kv_heads_matches_jax(runs):
    _, ref, ranks = runs
    cfg = get_smoke_config("qwen3_1_7b")
    _decode_close(ref, ranks, "qwen3_1_7b")
    for got in ranks:
        assert int(got["dec/qwen3_1_7b/kv_heads"]) == cfg.n_kv_heads // 2


@pytest.mark.parametrize("arch", ["mamba2_370m", "jamba_v0_1_52b"])
def test_greedy_decode_on_local_ssm_heads_matches_jax(runs, arch):
    """8 greedy steps at (2, 2), each rank's SSM state its block (its
    rows, H/2 heads): tokens equal to the reference's, logits within 1e-5
    and each rank's final state within 1e-5 of its rows and heads of the
    reference's."""
    _, ref, ranks = runs
    H = get_smoke_config(arch).ssm_heads
    _decode_close(ref, ranks, arch)
    want = ref[f"dec/{arch}/state"]             # (..., B, H, P, N)
    for r, got in enumerate(ranks):
        d, m = divmod(r, 2)
        st = got[f"dec/{arch}/state"]
        assert st.shape[-3] == H // 2
        _close(st, want[..., 2 * d:2 * d + 2,
                        m * H // 2:(m + 1) * H // 2, :, :])


def test_mixer_runs_whole_where_heads_do_not_divide(runs):
    """At (1, 4) a Mamba2 mixer of 6 heads runs whole under the rules,
    bit for bit as with none (its state and cache hold all 6 heads); the
    smoke config's 8 heads run 2 a rank, within 1e-5 of the whole."""
    _, _, ranks = runs
    for got in ranks:
        assert got["mixer/odd/exact"]
        assert int(got["mixer/odd/state_heads"]) == 6
        assert int(got["mixer/odd/cache_heads"]) == 6
        assert int(got["mixer/split/state_heads"]) == 2
        assert int(got["mixer/split/cache_heads"]) == 2
        assert float(got["mixer/split/err"]) <= TOL


def test_rank_reads_only_its_ssm_heads(runs):
    """At (1, 4), with every slice of the mixer's leaves that belongs to
    another rank's heads set to NaN (their z, x and dt columns of
    ``in_proj``, x channels of ``conv_w``, entries of ``a_log``,
    ``ssm_d``, ``dt_bias`` and ``gate_norm``, rows of ``out_proj``), a
    rank's forward output and state and its decode output and state are
    bit for bit those of the clean leaves."""
    _, _, ranks = runs
    for got in ranks:
        assert got["mixer/poisoned_equal"].all()
