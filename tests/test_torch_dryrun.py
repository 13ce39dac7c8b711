"""The port's dry run (``launch/dryrun.py``) and per-layer recompute
(``models/transformer.py::_Recompute``) against the JAX package, on the
CPU.

* The federated round on ``lm_loss(loss_chunk=8, remat=True)``: before
  this slice the port's chunked loss used ``torch.utils.checkpoint``,
  which cannot run under the round's ``torch.func.vmap`` of ``grad``
  (``RuntimeError: torch.func.{grad, vjp, jacrev, hessian} don't yet
  support saved tensor hooks``).  The round now matches the jitted
  reference's under ``tests/torch_fed_rules.py``'s ``gather_q`` rule, and
  ``remat`` gives the losses and gradients of ``remat=False``.
* The meters: FLOPs of the prefill, decode and plain-train steps against
  the reference's ``hlo_flops`` of the same jitted step on one CPU device,
  the arguments' bytes against its ``memory_analysis()``, the collectives
  of a ``gather_q`` round on a fake world of 4 against the wire the round
  reports, and the ring formulas against the reference's
  ``collective_bytes``.  Importing ``repro.launch.dryrun`` asks jax for
  512 host devices, so the reference runs in a subprocess; so does every
  fake world of the port.
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as JB
from repro.core import fed_step as J
from repro.launch import specs as JS
from repro.models import transformer as JT
from repro_torch.configs import base as B
from repro_torch.core import fed_step as F
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as S
from repro_torch.models import transformer as T
from repro_torch.utils.tree import from_numpy, leaves, tree_map

from torch_fed_rules import assert_gather_q_close, quant_stats
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
# one family each: dense, MoE, SSM, hybrid, encoder-decoder, VLM
FAMILIES = {"qwen3_1_7b": "dense", "phi3_5_moe_42b": "moe",
            "mamba2_370m": "ssm", "jamba_v0_1_52b": "hybrid",
            "whisper_tiny": "encdec", "internvl2_2b": "vlm"}
# small input shapes for the smoke configs
TINY = {"tiny_train": B.InputShape("tiny_train", 32, 4, "train"),
        "tiny_prefill": B.InputShape("tiny_prefill", 32, 2, "prefill"),
        "tiny_decode": B.InputShape("tiny_decode", 64, 2, "decode")}
# Mamba2-370M's decode_32k at 16 x 16: the rules' block of a rank
MAMBA2_DECODE_BLOCK = 766_939_172
# the SSM and the hybrid: the port computes the intra-chunk step through
# kernel C's plain version (``kernels/ssd_scan.py``), whose products the
# reference's own jnp scan (``models/ssm.py``) forms in another
# decomposition; their training FLOPs differ by this share (3.2% for
# Mamba2's smoke config, 0.4% for Jamba's), prefill and decode by none
SSM_FLOP_SHARE = 0.05
# ... and with ``remat`` also by the recomputed blocks' outputs (below)
SSM_REMAT_FLOP_SHARE = 0.15
GRAD_TOL = 1e-6

REFERENCE = textwrap.dedent('''
    import json, sys
    import jax
    from repro.launch import dryrun as JD
    from repro.launch import specs as JS
    from repro.configs.base import INPUT_SHAPES, InputShape, get_smoke_config
    INPUT_SHAPES["tiny_train"] = InputShape("tiny_train", 32, 4, "train")
    INPUT_SHAPES["tiny_prefill"] = InputShape("tiny_prefill", 32, 2,
                                              "prefill")
    INPUT_SHAPES["tiny_decode"] = InputShape("tiny_decode", 64, 2, "decode")
    out = {}
    for arch in sys.argv[1:]:
        cfg = get_smoke_config(arch)
        steps = {}
        for remat in (False, True):
            fn, _ = JD.build_train(cfg, None, None, plain=True, remat=remat)
            steps[f"train_remat{int(remat)}"] = (fn, [
                JS.param_specs(cfg), JS.batch_specs(cfg, "tiny_train")])
        steps["prefill"] = (JD.build_prefill(cfg, None), [
            JS.param_specs(cfg), JS.batch_specs(cfg, "tiny_prefill")])
        tok, cache, pos, _ = JS.decode_specs(cfg, "tiny_decode")
        steps["decode"] = (JD.build_decode(cfg, "tiny_decode", None),
                           [JS.param_specs(cfg), tok, pos, cache])
        for k, (f, a) in steps.items():
            # keep_unused: the step's every argument, as the port holds it
            c = jax.jit(f, keep_unused=True).lower(*a).compile()
            out[f"{arch}/{k}"] = {
                "flops": JD.hlo_flops(c.as_text()),
                "arg": c.memory_analysis().argument_size_in_bytes}
    txt = """HloModule m

    ENTRY %main (x: f32[16,1024]) -> f32[16,1024] {
      %x = f32[16,1024] parameter(0)
      %ag = f32[16,1024] all-gather(%x), replica_groups=[16,16]<=[256], dimensions={0}
      ROOT %ar = f32[16,1024] all-reduce(%ag), replica_groups=[16,16]<=[256], to_apply=%add
    }
    """
    out["ring"] = JD.collective_bytes(txt, 256)
    print(json.dumps(out))
''')

FAKE_WORLD = textwrap.dedent('''
    import json
    import numpy as np, torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.fed_step import FedConfig, make_fed_train_step
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.core import fed_step as F
    from repro_torch.sharding.rules import (Rules, active_rules, mesh_size,
                                            param_blocks, use_rules)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = make_host_mesh(2, 2)
    cfg = get_smoke_config("smollm_135m")
    params = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    blocks = param_blocks(params, Rules(mesh))
    loss = lambda p, b: T.lm_loss(p, b, cfg)[0]
    out = {}
    for pq in (8, 4):
        fed = FedConfig(n_groups=2, local_steps=1, lr=1e-2, p_q=pq)
        step = make_fed_train_step(loss, fed)
        box = {}
        def fn(*a):
            box["out"] = step(*a)
            return box["out"]
        # the rank's group: its 2 rows of the (4, 32) batch
        rec = D.trace_step(fn, [blocks, {"tokens": torch.zeros(
            (2, 32), dtype=torch.int32)}, torch.zeros(2, dtype=torch.int32)],
            mesh)
        # the local step alone: its tensor-parallel collectives
        def local(w, b):
            with use_rules(F._local_rules(active_rules(), fed)):
                return torch.func.vmap(
                    lambda x: F._group_local_train(w, x, loss, fed))(b)
        tp = D.trace_step(local, [blocks, {"tokens": torch.zeros(
            (1, 1, 2, 32), dtype=torch.int32)}], mesh)["collectives"]
        out[pq] = {"coll": rec["collectives"], "local": tp,
                   "wire": int(box["out"][1]["wire_bytes"]),
                   "data": mesh_size(mesh, "data")}
    # the functional collectives: the group by its name, the reduce op a
    # string beside it, a wait moving nothing
    name = dist.group.WORLD.group_name

    def functional(x):
        y = torch.ops._c10d_functional.all_reduce(x, "sum", name)
        y = torch.ops._c10d_functional.wait_tensor(y)
        return y, torch.ops._c10d_functional.reduce_scatter_tensor(
            x, "sum", 4, name)

    out["functional"] = D.trace_step(functional, [torch.zeros(16)])[
        "collectives"]
    dist.destroy_process_group()
    print(json.dumps(out))
''')


FAKE_WORLD_16 = textwrap.dedent('''
    import json
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs.base import (INPUT_SHAPES, InputShape,
                                          get_smoke_config)
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    INPUT_SHAPES["tiny_train"] = InputShape("tiny_train", 32, 4, "train")
    INPUT_SHAPES["tiny_prefill"] = InputShape("tiny_prefill", 32, 4,
                                              "prefill")
    INPUT_SHAPES["tiny_decode"] = InputShape("tiny_decode", 64, 4, "decode")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=16)
    out = {}
    for shape in ((4, 4), (1, 16)):
        mesh = make_host_mesh(*shape)
        for arch in ("qwen3_1_7b", "granite_34b"):
            for s in ("tiny_train", "tiny_prefill", "tiny_decode"):
                rec = D.trace_record(get_smoke_config(arch), s, mesh,
                                     loss_chunk=8)
                out[f"{shape}/{arch}/{s}"] = rec["memory"]
    print(json.dumps(out))
''')


class _Mesh16x16:
    """The (16, 16) mesh's axis names and sizes, all ``Rules.spec``
    reads."""
    mesh = torch.zeros(16, 16)
    mesh_dim_names = ("data", "model")


def _start(argv):
    return subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            env=ENV)


def _finish(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return out


@pytest.fixture(scope="module", autouse=True)
def runs():
    """The subprocesses of this module, started together at its start
    (the reference's compiles in two halves)."""
    tmp = tempfile.mkdtemp(prefix="dryrun_test_")
    archs = list(FAMILIES)
    procs = {
        "reference": _start([sys.executable, "-c", REFERENCE,
                             *archs[:3]]),
        "reference2": _start([sys.executable, "-c", REFERENCE,
                              *archs[3:]]),
        "world": _start([sys.executable, "-c", FAKE_WORLD]),
        "world16": _start([sys.executable, "-c", FAKE_WORLD_16]),
        "full": _start([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "qwen3_1_7b", "--shape", "decode_32k",
                        "--out",
                        os.path.join(tmp, "dryrun.json")]),
        "full_mamba2": _start([sys.executable, "-m",
                               "repro_torch.launch.dryrun", "--arch",
                               "mamba2_370m", "--shape", "decode_32k",
                               "--out",
                               os.path.join(tmp, "dryrun_mamba2.json")]),
    }
    yield procs, tmp
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def reference(runs):
    out = json.loads(_finish(runs[0]["reference"]))
    out.update(json.loads(_finish(runs[0]["reference2"])))
    return out


# ----------------------------------------------------------------------
# the fault and its repair
# ----------------------------------------------------------------------
def test_pre_repair_checkpoint_raises_under_func():
    """The chunked loss as it was: each chunk through
    ``torch.utils.checkpoint(..., use_reentrant=False)``, which the
    round's ``torch.func`` transforms refuse."""
    from torch.utils.checkpoint import checkpoint
    w = torch.randn(8, 5)

    def loss(w, x):
        return checkpoint(lambda a, b: torch.sum(torch.tanh(a @ b)), x, w,
                          use_reentrant=False)

    with pytest.raises(RuntimeError, match="saved tensor hooks"):
        torch.func.vmap(torch.func.grad_and_value(loss),
                        in_dims=(None, 0))(w, torch.randn(2, 3, 8))


@pytest.mark.parametrize("loss_chunk,remat", [(8, True), (0, True)])
def test_fed_round_chunked_loss_and_remat_match_jax(loss_chunk, remat):
    """SmolLM-135M's smoke config, tokens (4, 32) from
    ``RandomState(0)``, two groups of one step, staleness zeros, the JAX
    weights carried across: the port's round against the jitted
    reference's round on the same loss."""
    jcfg, cfg = JB.get_smoke_config("smollm_135m"), \
        B.get_smoke_config("smollm_135m")
    jw = JT.init_model(jax.random.PRNGKey(0), jcfg)
    kw = dict(n_groups=2, local_steps=1, lr=1e-2)
    fed_j, fed_t = J.FedConfig(**kw), F.FedConfig(**kw)
    tokens = np.random.RandomState(0).randint(0, jcfg.vocab, (4, 32)).astype(
        np.int32)
    stale = np.zeros(2, np.int32)
    jloss = lambda p, b: JT.lm_loss(p, b, jcfg, remat=remat,  # noqa: E731
                                    loss_chunk=loss_chunk)[0]
    jround, stats = J.make_fed_train_step(jloss, fed_j), quant_stats(
        jloss, fed_j)

    @jax.jit
    def ref(w, b, st):
        return jround(w, b, st) + (stats(w, b),)

    pj, mj, sj = ref(jw, {"tokens": jnp.asarray(tokens)}, jnp.asarray(stale))
    tw = from_numpy(jax.tree.map(np.asarray, jw), "cpu")
    pt, mt = F.make_fed_train_step(
        lambda p, b: T.lm_loss(p, b, cfg, remat=remat,
                               loss_chunk=loss_chunk)[0], fed_t)(
        tw, {"tokens": torch.from_numpy(tokens)}, torch.from_numpy(stale))
    assert float(mj["local_loss"]) == pytest.approx(6.3119, abs=1e-4)
    assert abs(float(mt["local_loss"]) - float(mj["local_loss"])) <= 1e-5
    assert_gather_q_close([x.numpy() for x in leaves(pt)],
                          [np.asarray(x) for x in jax.tree.leaves(pj)], sj,
                          fed_j.p_q)


@pytest.mark.parametrize("arch", list(FAMILIES) + ["smollm_135m",
                                                   "llama4_scout_17b"])
def test_remat_gives_the_same_losses_and_grads(arch):
    """``remat=True`` (and the chunked loss beside it) against the plain
    loss: the value and every gradient leaf, alone and under the round's
    ``torch.func.vmap`` of ``grad``."""
    cfg = B.get_smoke_config(arch)
    p = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(1)
    b = {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab, (2, 16)))}
    if cfg.is_encoder_decoder:
        b["frames"] = torch.from_numpy(rng.randn(
            2, cfg.enc_seq, cfg.d_model).astype(np.float32))
    if cfg.n_patches:
        b["patches"] = torch.from_numpy(rng.randn(
            2, cfg.n_patches, cfg.d_model).astype(np.float32))
    b2 = tree_map(lambda v: torch.stack([v, v.flip(0)]), b)

    def both(**kw):
        f = lambda q, x: T.lm_loss(q, x, cfg, **kw)[0]  # noqa: E731
        g, l = torch.func.grad_and_value(f)(p, b)
        gv, lv = torch.func.vmap(torch.func.grad_and_value(f),
                                 in_dims=(None, 0))(p, b2)
        return [l, lv] + leaves(g) + leaves(gv)

    want = both()
    for kw in (dict(remat=True), dict(remat=True, loss_chunk=4)):
        got = both(**kw)
        for x, y in zip(got, want):
            assert torch.allclose(x, y, rtol=0, atol=GRAD_TOL), (kw, float(
                (x - y).abs().max()))


def test_remat_frees_each_layers_activations():
    """The dry run's peak: with ``remat`` the backward holds one layer's
    recomputed activations at a time (``_Recompute`` builds no graph of
    its own backward inside ``torch.func.grad``)."""
    import dataclasses
    cfg = dataclasses.replace(B.get_config("smollm_135m"), n_layers=6,
                              vocab=512)
    temps = {}
    for remat in (False, True):
        fn, _ = D.build_train(cfg, None, None, plain=True, remat=remat)
        args = [S.param_specs(cfg), {"tokens": torch.empty(
            (4, 256), dtype=torch.int32, device="meta")}]
        temps[remat] = D.trace_step(fn, args)["memory"]["temp_size_in_bytes"]
    assert temps[True] < 0.4 * temps[False], temps


# ----------------------------------------------------------------------
# the meters
# ----------------------------------------------------------------------
def test_ring_formulas_are_the_references(reference):
    nbytes = 16 * 1024 * 4
    ag = D.ring_bytes("all-gather", nbytes, 16)
    ar = D.ring_bytes("all-reduce", nbytes, 16)
    ring = reference["ring"]
    assert ag == pytest.approx(nbytes * 15 / 16) == ring["all-gather"]
    assert ar == pytest.approx(2 * nbytes * 15 / 16) == ring["all-reduce"]
    assert ag + ar == ring["total"]
    for kind in ("reduce-scatter", "all-to-all", "collective-permute"):
        assert D.ring_bytes(kind, nbytes, 16) == ag
    assert D.ring_bytes("all-reduce", nbytes, 1) == 0.0


def _port_steps(arch):
    cfg = B.get_smoke_config(arch)
    steps = {}
    for remat in (False, True):
        fn, _ = D.build_train(cfg, None, None, plain=True, remat=remat)
        steps[f"train_remat{int(remat)}"] = (fn, [
            S.param_specs(cfg), S.batch_specs(cfg, "tiny_train")])
    steps["prefill"] = (D.build_prefill(cfg, None), [
        S.param_specs(cfg), S.batch_specs(cfg, "tiny_prefill")])
    tok, cache, pos, _ = S.decode_specs(cfg, "tiny_decode")
    steps["decode"] = (D.build_decode(cfg, "tiny_decode", None),
                       [S.param_specs(cfg), tok, pos, cache])
    return cfg, steps


@pytest.fixture
def tiny_shapes(monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setitem(B.INPUT_SHAPES, k, v)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_flops_and_arguments_match_reference(arch, reference, tiny_shapes):
    """The no-mesh steps at the small shapes: arguments exactly; FLOPs of
    prefill and decode within 1% (they are equal); the plain step without
    remat within 1% for dense, MoE, encoder-decoder and VLM, within
    ``SSM_FLOP_SHARE`` for the SSM and the hybrid.  With remat (the dry
    run's train step), XLA drops the recomputed blocks' outputs, which no
    gradient reads, and eager recompute computes them: the port counts
    one more forward of each layer's last projection (``w_down``), which
    is the whole difference for dense and VLM; MoE's last op is its cheap
    combine (within 1%); the encoder-decoder recomputes nothing (equal)."""
    cfg, steps = _port_steps(arch)
    fam = FAMILIES[arch]
    for key, (fn, args) in steps.items():
        rec = D.trace_step(fn, args)
        want = reference[f"{arch}/{key}"]
        assert rec["memory"]["argument_size_in_bytes"] == want["arg"], key
        got = rec["cost"]["flops"]
        assert got == rec["cost"]["flops_trip_aware"]
        rel = abs(got - want["flops"]) / want["flops"]
        if key in ("prefill", "decode"):
            assert rel <= 0.01, (key, got, want)
        elif key == "train_remat0":
            assert rel <= (SSM_FLOP_SHARE if fam in ("ssm", "hybrid")
                           else 0.01), (key, got, want)
        elif fam in ("dense", "vlm"):
            tokens = 4 * (32 + cfg.n_patches)
            extra = cfg.n_layers * 2 * tokens * cfg.d_ff * cfg.d_model
            assert got - want["flops"] == extra, (got, want)
        elif fam in ("moe", "encdec"):
            assert rel <= 0.01, (key, got, want)
        else:
            assert rel <= SSM_REMAT_FLOP_SHARE, (key, got, want)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_flops_are_flop_counter_modes(arch, tiny_shapes):
    """The meter's FLOPs are ``FlopCounterMode``'s on the same steps."""
    _, steps = _port_steps(arch)
    for key, (fn, args) in steps.items():
        with FlopCounterMode(display=False) as fc:
            fn(*args)
        assert D.trace_step(fn, args)["cost"]["flops"] == \
            fc.get_total_flops(), key


def test_memory_meter_follows_storages():
    """A step of known allocations: two live temporaries at its peak,
    views and in-place ops adding none, the output its own storage."""
    x = torch.zeros(1000)

    def fn(x):
        a = x * 2                      # 4,000 B
        b = a[10:].add_(1)             # a view, in place: none
        c = a + 1                      # 4,000 B: the peak, 8,000 B
        del a, b
        return c.sum()                 # 4 B out

    rec = D.trace_step(fn, [x])
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == 4000
    assert mem["temp_size_in_bytes"] == 8000
    assert mem["output_size_in_bytes"] == 4
    # mul reads 4,000 and writes 4,000; add_ 3,960 twice; add 8,000; sum
    # reads 4,000 and writes 4
    assert rec["cost"]["bytes accessed"] == 8000 + 2 * 3960 + 8000 + 4004


@pytest.fixture(scope="module")
def world(runs):
    return json.loads(_finish(runs[0]["world"]))


def test_functional_collectives_metered(world):
    """``_c10d_functional`` ops on the fake world of 4: the group size
    from ``group_name`` (not the reduce op's string before it), the ring
    bytes of 64-byte and 16-byte results, and no entry for the wait."""
    assert world["functional"] == {
        "all-reduce": 2 * 64 * 3 / 4, "all-reduce_count": 1,
        "reduce-scatter": 16 * 3 / 4, "reduce-scatter_count": 1,
        "total": 2 * 64 * 3 / 4 + 16 * 3 / 4}


def test_collective_without_group_raises():
    """A collective whose arguments hold no process group is an error,
    not a collective of 0 bytes."""
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="c10d::allreduce_"):
        D._group_size(torch.ops.c10d.allreduce_.default, ([x], None), {})


def test_fed_round_collectives_are_its_wire(world):
    """A ``gather_q`` round of SmolLM's smoke config on a (2, 2) mesh of
    a fake world of 4, on the rank's blocks: beside its local step's
    tensor-parallel collectives (the same step traced alone), the
    all-gathers over ``data`` move the round's reported wire (levels and
    scales; at ``p_q`` 4 two levels a byte) and one all-reduce the two
    metrics' sums.  No all-gather over ``model`` remains: the round
    returns the blocks."""
    out = {k: v for k, v in world.items() if k != "functional"}
    assert out["4"]["wire"] < out["8"]["wire"]
    for pq, r in out.items():
        coll, tp = r["coll"], r["local"]
        assert tp["all-reduce_count"] > 0 and tp["all-gather_count"] > 0
        assert coll["all-gather_count"] == 2 + tp["all-gather_count"], coll
        data = r["wire"] * (r["data"] - 1)
        assert coll["all-gather"] == pytest.approx(data + tp["all-gather"],
                                                   rel=1e-12)
        assert coll["all-reduce_count"] == 1 + tp["all-reduce_count"]
        assert coll["all-reduce"] == pytest.approx(
            2 * 8 * 3 / 4 + tp["all-reduce"], rel=1e-12)
        assert coll["total"] == coll["all-gather"] + coll["all-reduce"]


@pytest.mark.parametrize("arch", [a for a in B.ARCH_IDS
                                  if a != "fmnist_cnn"])
def test_wire_matches_reference(arch):
    cfg, jcfg = B.get_config(arch), JB.get_config(arch)
    for G in (16, 32):
        want = J.fed_wire_bytes(JS.param_specs(jcfg), J.FedConfig(
            n_groups=G), G)
        got = F.fed_wire_bytes(S.param_specs(cfg), F.FedConfig(n_groups=G),
                               G)
        assert got == want


def test_arguments_are_the_rules_block_on_16_ranks(runs):
    """Smoke configs of Qwen3 (whole q heads, mid-head kv at model 4; mid-
    head q at 16) and Granite (MQA) on a fake world of 16, meshes (4, 4)
    and (1, 16): in the round, the prefill and the decode each rank holds
    exactly the blocks the rules give it, well under the whole."""
    recs = json.loads(_finish(runs[0]["world16"]))
    assert len(recs) == 12
    for key, mem in recs.items():
        assert mem["argument_size_in_bytes"] == \
            mem["rules_block_size_in_bytes"], key


def test_full_width_record(runs):
    """``python -m repro_torch.launch.dryrun --arch qwen3_1_7b --shape
    decode_32k`` on a fake world of 256: one record, no error, the
    reference's parameter counts and record keys."""
    _finish(runs[0]["full"])
    with open(os.path.join(runs[1], "dryrun.json")) as f:
        recs = json.load(f)
    assert len(recs) == 1 and "error" not in recs[0]
    r, cfg = recs[0], JB.get_config("qwen3_1_7b")
    assert (r["arch"], r["shape"], r["mesh"], r["step"]) == \
        ("qwen3_1_7b", "decode_32k", "16x16", "decode")
    assert r["params"] == cfg.param_count()
    assert r["active_params"] == cfg.active_param_count()
    assert r["rolling_window"] == 0
    mem = r["memory"]
    # the rank's blocks of the bf16 parameters (each split leaf a 16th:
    # every split dim of Qwen3 divides 16) and its 8 rows of the cache,
    # whose 8 kv heads do not split 16 ways
    specs = D.param_shardings(D.Rules(_Mesh16x16()), S.param_specs(
        B.get_config("qwen3_1_7b")))
    params = sum(x.numel() * 2 // (16 if any(sp) else 1) for x, sp in zip(
        leaves(S.param_specs(B.get_config("qwen3_1_7b"))),
        leaves(specs, is_leaf=lambda v: isinstance(v, tuple))))
    cache = 2 * 2 * cfg.n_layers * 8 * 32768 * cfg.n_kv_heads * cfg.head_dim
    assert mem["argument_size_in_bytes"] == params + cache + 8 * 4 + 4
    assert mem["rules_block_size_in_bytes"] == mem["argument_size_in_bytes"]
    # the attention's and the MLP's partial sums, the wk/wv gathers
    assert r["cost"]["flops"] > 0 and r["collectives"]["all-reduce"] > 0


def test_full_width_mamba2_record_holds_its_heads_of_the_state(runs):
    """``python -m repro_torch.launch.dryrun --arch mamba2_370m --shape
    decode_32k`` on a fake world of 256: a rank holds its 2 of the 32
    ``ssm_heads`` of the f32 state (batch 8 a rank, 48 layers), so its
    arguments are the rules' block, 766,939,172 B (the whole state a rank
    held 377,487,360 B more); each layer's mixer all-reduces its partial
    output and its gated norm's statistic."""
    _finish(runs[0]["full_mamba2"])
    with open(os.path.join(runs[1], "dryrun_mamba2.json")) as f:
        recs = json.load(f)
    assert len(recs) == 1 and "error" not in recs[0]
    r, cfg = recs[0], B.get_config("mamba2_370m")
    mem = r["memory"]
    assert mem["argument_size_in_bytes"] == \
        mem["rules_block_size_in_bytes"] == MAMBA2_DECODE_BLOCK
    whole_state = cfg.n_layers * 8 * cfg.ssm_heads * cfg.ssm_head_dim * \
        cfg.ssm_state * 4
    assert MAMBA2_DECODE_BLOCK + whole_state * 15 // 16 == 1_144_426_532
    assert r["collectives"]["all-reduce_count"] == 2 * cfg.n_layers


# the records whose SSM state a rank held whole before the mixer split
# its heads: (arch, shape, mesh) -> the rules' block in bytes
SSM_STATE_RECORDS = {
    ("mamba2_370m", "decode_32k", "16x16"): 766_939_172,
    ("mamba2_370m", "long_500k", "16x16"): 740_274_184,
    ("mamba2_370m", "decode_32k", "2x16x16"): 751_702_036,
    ("mamba2_370m", "long_500k", "2x16x16"): 740_274_184,
    ("jamba_v0_1_52b", "decode_32k", "16x16"): 16_071_822_372,
    ("jamba_v0_1_52b", "long_500k", "16x16"): 11_894_978_824,
    ("jamba_v0_1_52b", "decode_32k", "2x16x16"): 13_915_142_164,
    ("jamba_v0_1_52b", "long_500k", "2x16x16"): 11_894_978_824,
}


def test_committed_records_hold_the_rules_block():
    """Every record of the committed ``results/torch/dryrun.json`` (10
    archs x 4 shapes x 2 meshes, no error) holds exactly the rules'
    block, the SSM state's records included."""
    with open(os.path.join(ROOT, "results", "torch", "dryrun.json")) as f:
        recs = json.load(f)
    assert len(recs) == 80
    seen = {}
    for r in recs:
        assert "error" not in r, (r["arch"], r["shape"], r["mesh"])
        mem = r["memory"]
        assert mem["argument_size_in_bytes"] == \
            mem["rules_block_size_in_bytes"], (r["arch"], r["shape"],
                                               r["mesh"])
        seen[r["arch"], r["shape"], r["mesh"]] = mem[
            "argument_size_in_bytes"]
    assert len(seen) == 80
    for key, block in SSM_STATE_RECORDS.items():
        assert seen[key] == block, key


def test_unsharded_gather_q_round_takes_bf16_params():
    """The port's unsharded ``gather_q`` round with bf16 parameters (the
    dry run's dtype): kernel B's channel form now takes f32 rows, as the
    reference's ``compress_delta`` casts, so the combine is f32 (it
    raised a dtype error before) and the round matches the jitted
    reference's within bf16 noise."""
    jcfg, cfg = JB.get_smoke_config("smollm_135m"), \
        B.get_smoke_config("smollm_135m")
    jw = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                      JT.init_model(jax.random.PRNGKey(0), jcfg))
    kw = dict(n_groups=2, local_steps=1, lr=1e-2)
    tokens = np.random.RandomState(0).randint(0, jcfg.vocab, (4, 32)).astype(
        np.int32)
    stale = np.zeros(2, np.int32)
    pj, mj = jax.jit(J.make_fed_train_step(
        lambda p, b: JT.lm_loss(p, b, jcfg)[0], J.FedConfig(**kw)))(
        jw, {"tokens": jnp.asarray(tokens)}, jnp.asarray(stale))
    tw = tree_map(lambda a: torch.from_numpy(np.asarray(
        a, np.float32)).to(torch.bfloat16), jax.tree.map(np.asarray, jw))
    pt, mt = F.make_fed_train_step(
        lambda p, b: T.lm_loss(p, b, cfg)[0], F.FedConfig(**kw))(
        tw, {"tokens": torch.from_numpy(tokens)}, torch.from_numpy(stale))
    assert all(x.dtype == torch.bfloat16 for x in leaves(pt))
    assert abs(float(mt["local_loss"]) - float(mj["local_loss"])) <= 2e-3
    for g, w, w0 in zip(leaves(pt), jax.tree.leaves(pj), jax.tree.leaves(jw)):
        g = g.to(torch.float32).numpy()
        w, w0 = np.asarray(w, np.float32), np.asarray(w0, np.float32)
        # a bf16 rounding of w0 + update that falls the other way moves an
        # element by up to the round's update plus a bf16 step of it: on
        # at most 2% of the elements
        err = np.abs(g - w)
        bound = np.abs(w - w0).max() + 2 ** -7 * np.abs(w)
        assert np.all(err <= bound)
        assert (err > 0).mean() <= 0.02
