"""Multi-pod dry run: trace every (arch x input shape x mesh) as one
rank's program on fake tensors.

The JAX package's ``launch/dryrun.py`` lowers and compiles each step for
512 placeholder host devices and reads XLA's memory and cost analyses
and the HLO's collectives.  The port is one process per rank, so its
twin runs rank 0's program of a 256- or 512-rank world: a ``"fake"``
process group (``torch.testing``'s ``FakeStore``, whose collectives move
nothing), the production mesh over it, and every input a fake tensor of
``launch/specs.py`` (a shape, a dtype and no storage).  Each step runs
eagerly under three meters (:func:`trace_step`):

* FLOPs by ``torch.utils.flop_counter``'s formulas, as
  ``FlopCounterMode`` counts them.  Eager execution runs every loop
  iteration, so ``flops_trip_aware`` equals ``flops``;
* bytes accessed: each op's operand and result bytes (views and
  allocations move none), the eager traffic;
* collectives from the ``c10d`` (and ``_c10d_functional``) ops that
  reach the dispatcher, with the group size from the op's process group
  and the JAX package's ring formulas (:func:`ring_bytes`);
* memory from this module's own storage tracker: the arguments are what
  the rank holds (its blocks of the parameters, ``param_blocks``, and of
  the batch and the cache), the peak of live storages during the step
  less the arguments is the temp size, and the output is the returned
  tensors' storages.

It is a host tool, as the JAX package's is: it launches nothing on a
card.  On fake CPU tensors every kernel wrapper takes its plain version,
so kernel C's work is counted through it.  The HLO parsers of the JAX
package have no counterpart (there is no HLO); the meters take their
role.

  python -m repro_torch.launch.dryrun --arch all --shape all --both-meshes

writes ``results/torch/dryrun.json`` (resuming by record key), each
record traced in a spawned process of its own, up to 8 at once.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core.fed_step import (FedConfig, fed_wire_bytes,
                                       make_fed_train_step)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.sharding.rules import (Rules, axes_size, local_block,
                                        param_blocks, param_shardings,
                                        use_rules)
from repro_torch.utils.tree import leaves, tree_map

TRANSFORMER_ARCHS = tuple(a for a in ARCH_IDS if a != "fmnist_cnn")


# ----------------------------------------------------------------------
# the steps
# ----------------------------------------------------------------------
def build_train(cfg, rules, fed: Optional[FedConfig], plain: bool,
                remat: bool = True, loss_chunk: int = 0):
    """-> (step, is_fed): the plain SGD step or the federated round on
    ``lm_loss`` with per-layer recompute."""
    def loss_fn(p, b):
        return T.lm_loss(p, b, cfg, remat=remat, loss_chunk=loss_chunk)[0]

    if plain:
        def step(params, batch):
            grads, loss = torch.func.grad_and_value(loss_fn)(params, batch)
            new = tree_map(lambda p, g: (p - 1e-3 * g).to(p.dtype), params,
                           grads)
            return new, loss
        return step, False
    return make_fed_train_step(loss_fn, fed), True


def build_args_train(cfg, shape_name, rules, fed: Optional[FedConfig]):
    """-> (args, their specs): params and batch, and the staleness of the
    federated round; the specs cut each rank's block of the batch (the
    round's rows are its groups')."""
    params = S.param_specs(cfg)
    batch = S.batch_specs(cfg, shape_name)
    args = [params, batch]
    in_sh = [None, None if rules is None else S.batch_shardings(rules, batch)]
    if fed is not None:
        args.append(torch.empty((fed.n_groups,), dtype=torch.int32,
                                device=S.META))
        in_sh.append(None)
    return args, in_sh


def build_prefill(cfg, rules):
    if cfg.is_encoder_decoder:
        def step(params, batch):
            return T.encdec_prefill(params, batch, cfg,
                                    cache_len=batch["tokens"].shape[1])
    else:
        def step(params, batch):
            return T.prefill(params, batch, cfg)
    return step


def build_decode(cfg, shape_name, rules, seq_shard_kv: bool = False,
                 kv_quant: bool = False):
    _, _, _, rolling = S.decode_specs(cfg, shape_name, quantized=kv_quant)

    def step(params, tok, pos, cache):
        return T.decode_step(params, tok["tokens"], pos, cfg, cache,
                             rolling=rolling, seq_shard_kv=seq_shard_kv)

    return step


# ----------------------------------------------------------------------
# the meters
# ----------------------------------------------------------------------
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
# c10d ops that move no data of their own
_WAITS = {"wait_tensor", "barrier", "monitored_barrier_"}
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided"}


def ring_bytes(kind: str, nbytes: float, group: int) -> float:
    """Per-rank link bytes of one collective whose result holds ``nbytes``
    over a group of ``group`` ranks (the JAX package's ring estimates):
    all-gather ``b (g-1)/g``, all-reduce ``2 b (g-1)/g``, the others
    ``b (g-1)/g``."""
    frac = (group - 1) / group if group > 1 else 0.0
    return (2 if kind == "all-reduce" else 1) * nbytes * frac


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _group_size(func, args, kwargs) -> int:
    """The size of the process group a collective runs over: its
    ``ProcessGroup`` argument (``c10d``) or its ``group_name``
    (``_c10d_functional``).  Raises a ValueError naming the op if it has
    neither, so that no collective drops out of the totals."""
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    for v in named.values():
        if isinstance(v, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(v).size()
            except RuntimeError:     # another script class (a ReduceOp)
                continue
    if isinstance(named.get("group_name"), str):
        from torch.distributed.distributed_c10d import \
            _resolve_process_group
        return _resolve_process_group(named["group_name"]).size()
    raise ValueError(f"{func._schema.name}: no process group among its "
                     f"arguments, so its bytes cannot be metered")


def _flat(values) -> list:
    """The tensors among ``values``, one list level deep (the c10d ops
    take lists of tensors)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


class _Meter(TorchDispatchMode):
    """FLOPs, bytes accessed, collectives and live storage bytes of every
    op below it.  FLOPs by ``torch.utils.flop_counter``'s formulas, keyed
    as ``FlopCounterMode`` keys them (the op's overload packet); the
    tests hold the total to ``FlopCounterMode``'s, which costs more than
    the step itself on these shapes."""

    def __init__(self, arg_bytes: int, arg_keys):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0.0
        self.coll: Dict[str, float] = {}
        self.live: Dict[int, Any] = {}
        self.arg_keys = set(arg_keys)
        self.cur = self.peak = arg_bytes
        self.kinds: Dict[Any, Any] = {}

    def _kind(self, func):
        """(collective kind or None, counts traffic, FLOP formula)."""
        ns, _, op = func._schema.name.partition("::")
        if ns in ("c10d", "_c10d_functional"):
            if op in _WAITS:
                return None, False, None
            return _COLLECTIVES.get(op, op), False, None
        return (None, not func.is_view and op not in _NO_TRAFFIC,
                self.registry.get(func._overloadpacket))

    def _freed(self, key: int, nbytes: int) -> None:
        if self.live.pop(key, None) is not None:
            self.cur -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live or key in self.arg_keys:
            return
        n = st.nbytes()
        self.live[key] = weakref.ref(
            st, lambda _, k=key, n=n: self._freed(k, n))
        self.cur += n
        if self.cur > self.peak:
            self.peak = self.cur

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        info = self.kinds.get(func)
        if info is None:
            info = self.kinds[func] = self._kind(func)
        kind, traffic, formula = info
        outs = _flat(out if isinstance(out, (list, tuple)) else (out,))
        if kind is not None:
            g = _group_size(func, args, kwargs)
            moved = ring_bytes(kind, sum(_nbytes(t) for t in outs), g)
            self.coll[kind] = self.coll.get(kind, 0.0) + moved
            self.coll[kind + "_count"] = self.coll.get(kind + "_count",
                                                       0) + 1
        elif traffic:
            self.bytes += sum(_nbytes(t) for t in
                              _flat(args) + _flat(kwargs.values()) + outs)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        for t in outs:
            self._track(t)
        return out


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in leaves(tree) for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _distinct_bytes(tensors) -> Dict[int, int]:
    return {_storage_key(t): t.untyped_storage().nbytes() for t in tensors}


def _meta_like(tree):
    """Each tensor of ``tree`` on the meta device with its shape, dtype
    and strides (a meta tensor as it is); tensors that share a storage
    share one here too."""
    bases: Dict[int, torch.Tensor] = {}

    def one(t):
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return t
        key = _storage_key(t)
        if key not in bases:
            bases[key] = torch.empty(t.untyped_storage().nbytes(),
                                     dtype=torch.uint8, device=S.META)
        return torch.empty(0, dtype=t.dtype, device=S.META).set_(
            bases[key].untyped_storage(), t.storage_offset(), t.shape,
            t.stride())

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return one(x)

    return walk(tree)


def trace_step(fn: Callable, args: Sequence[Any], mesh=None,
               in_specs: Optional[Sequence[Any]] = None) -> Dict[str, Any]:
    """Run ``fn(*args)`` once as this rank's program on meta tensors and
    meter it (the module docstring's meters).

    ``args``: trees (dicts, lists, tuples) of tensors, on any device, and
    other values; each tensor is traced as a meta tensor of its shape and
    dtype, so nothing is allocated and nothing is launched.  ``mesh``:
    run under ``use_rules(Rules(mesh))`` (without one, under no rules).
    ``in_specs``: per argument a tree of spec tuples (or None to pass it
    whole): the rank's block of each tensor, as ``local_block`` cuts it.
    -> {"cost", "collectives", "memory", "trace_s"} with the JAX
    package's record keys."""
    args = list(_meta_like(list(args)))
    if in_specs is not None:
        args = [a if sp is None else _cut(a, sp, mesh)
                for a, sp in zip(args, in_specs)]
    arg_sizes = _distinct_bytes(_tensors(args))
    arg_bytes = sum(arg_sizes.values())
    t0 = time.time()
    meter = _Meter(arg_bytes, arg_sizes)
    with use_rules(Rules(mesh) if mesh is not None else None), meter:
        out = fn(*args)
    trace_s = time.time() - t0
    out_sizes = _distinct_bytes(_tensors(out))
    total = float(meter.flops)
    coll = dict(meter.coll)
    coll["total"] = sum(v for k, v in coll.items()
                        if not k.endswith("_count"))
    return {
        "cost": {"flops": total, "flops_trip_aware": total,
                 "bytes accessed": meter.bytes,
                 "bytes_trip_aware": meter.bytes},
        "collectives": coll,
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": sum(out_sizes.values()),
                   "temp_size_in_bytes": meter.peak - arg_bytes},
        "trace_s": round(trace_s, 3),
    }


def _cut(tree, specs, mesh):
    """This rank's block of each tensor of ``tree`` under the matching
    spec tuple of ``specs`` (the same structure)."""
    if isinstance(tree, dict):
        return {k: _cut(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and specs is not None:
        # a tensor of its own, as the rank holds it (not a view of the
        # whole)
        return local_block(tree, specs, mesh).clone()
    return tree


def spec_bytes(args: Sequence[Any], specs: Sequence[Any], mesh) -> int:
    """The bytes of the rank's block of every tensor of ``args`` under the
    matching spec trees (None: whole)."""
    total = 0
    for a, sp in zip(args, specs):
        ts = _tensors(a)
        sps = [None] * len(ts) if sp is None else (
            leaves(sp, is_leaf=lambda v: not isinstance(v, dict))
            if isinstance(sp, dict) else [sp])
        total += sum(_nbytes(t) // (axes_size(mesh, q) if q else 1)
                     for t, q in zip(ts, sps))
    return total


# ----------------------------------------------------------------------
# the fake world
# ----------------------------------------------------------------------
def fake_world(size: int) -> None:
    """Join a ``"fake"`` process group of ``size`` ranks as rank 0, unless
    a world is already up.  Raises if ``torch.testing``'s fake store is
    missing."""
    if dist.is_initialized():
        return
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch.testing._internal.distributed.fake_pg "
            "(the 'fake' process group), which this torch lacks") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


# ----------------------------------------------------------------------
def trace_record(cfg, shape_name: str, mesh, *, step_kind: str = "fed",
                 fed_schedule: str = "gather_q", local_steps: int = 1,
                 p_q: int = 8, loss_chunk: int = 0,
                 seq_shard_kv: bool = False, kv_quant: bool = False,
                 group_parallelism: str = "tp") -> Dict[str, Any]:
    """One (config x input shape) step traced as this rank's program on
    ``mesh``, each rank holding its blocks of the params
    (``param_blocks``), of the batch and of the cache; with
    ``rules_block_size_in_bytes``, the bytes of the blocks the rules
    give it (``spec_bytes``)."""
    rules = Rules(mesh)
    shape = INPUT_SHAPES[shape_name]
    rec: Dict[str, Any] = {
        "step": step_kind if shape.kind == "train" else shape.kind}
    params = S.param_specs(cfg)
    held = param_blocks(params, rules)
    blk = param_shardings(rules, params)
    if shape.kind == "train":
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        n_groups = int(sizes.get("pod", 1) * sizes["data"])
        fed = None
        if step_kind == "fed":
            fed = FedConfig(n_groups=n_groups, local_steps=local_steps,
                            schedule=fed_schedule, p_q=p_q,
                            group_parallelism=group_parallelism)
            rec["fed"] = {"n_groups": n_groups, "schedule": fed_schedule,
                          "p_q": p_q, "local_steps": local_steps}
            rec["wire"] = fed_wire_bytes(params, fed, n_groups)
        fn, _ = build_train(cfg, rules, fed, plain=step_kind == "plain",
                            loss_chunk=loss_chunk)
        args, in_sh = build_args_train(cfg, shape_name, rules, fed)
    elif shape.kind == "prefill":
        fn = build_prefill(cfg, rules)
        batch = S.batch_specs(cfg, shape_name)
        args, in_sh = [params, batch], [None, S.batch_shardings(rules, batch)]
    else:  # decode
        fn = build_decode(cfg, shape_name, rules, seq_shard_kv=seq_shard_kv,
                          kv_quant=kv_quant)
        tok, cache, pos, rolling = S.decode_specs(cfg, shape_name,
                                                  quantized=kv_quant)
        rec["rolling_window"] = bool(rolling) and S.WINDOW or 0
        if seq_shard_kv:   # the sequence-sharded decode takes an int
            pos = shape.seq_len - 1
        args = [params, tok, pos, cache]
        in_sh = [None, S.batch_shardings(rules, tok), None,
                 S.cache_shardings(rules, cache, seq_shard=seq_shard_kv)]
    rec.update(trace_step(fn, [held] + args[1:], mesh, in_sh))
    # what GSPMD would hold per device under the same rules
    rec["memory"]["rules_block_size_in_bytes"] = spec_bytes(
        args, [blk] + in_sh[1:], mesh)
    return rec


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            variant: str = "", verbose: bool = True, **kw) -> Dict[str, Any]:
    """One record of the production grid: ``arch`` at ``shape_name`` on
    the (16, 16) mesh, or (2, 16, 16) with ``multi_pod``, as rank 0 of a
    fake world; ``kw`` as :func:`trace_record` takes them."""
    fake_world(512 if multi_pod else 256)
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    if variant:
        rec["variant"] = variant
    rec.update(trace_record(cfg, shape_name, mesh, **kw))
    if verbose:
        flops = rec["cost"]["flops"]
        coll = rec["collectives"]["total"]
        print(f"[dryrun] {arch:22s} {shape_name:12s} {rec['mesh']:8s} "
              f"trace={rec['trace_s']:7.1f}s flops/dev={flops:.3e} "
              f"coll/dev={coll:.3e}B", flush=True)
    return rec


def _record(arch: str, shape: str, multi_pod: bool, step: str,
            fed_schedule: str, p_q: int) -> Dict[str, Any]:
    """One record, or its error record."""
    try:
        return run_one(arch, shape, multi_pod=multi_pod, step_kind=step,
                       fed_schedule=fed_schedule, p_q=p_q)
    except Exception as e:
        print(f"[dryrun] FAIL {arch} {shape}: {e!r}", flush=True)
        return {"arch": arch, "shape": shape,
                "mesh": "2x16x16" if multi_pod else "16x16",
                "step": step, "error": repr(e),
                "traceback": traceback.format_exc()[-2000:]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (10 assigned archs)")
    ap.add_argument("--shape", default="all",
                    help="input shape or 'all' (4 assigned shapes)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--step", default="fed", choices=["fed", "plain"])
    ap.add_argument("--fed-schedule", default="gather_q",
                    choices=["gather_q", "gather_f32", "psum"])
    ap.add_argument("--p-q", type=int, default=8)
    ap.add_argument("--out", default="results/torch/dryrun.json")
    args = ap.parse_args(argv)

    archs = TRANSFORMER_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("step"),
             r.get("fed", {}).get("schedule")) for r in results}

    todo = []
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                train = INPUT_SHAPES[shape].kind == "train"
                key = (arch, shape, "2x16x16" if mp else "16x16",
                       args.step if train else INPUT_SHAPES[shape].kind,
                       args.fed_schedule if train and args.step == "fed"
                       else None)
                if key not in done:
                    todo.append((arch, shape, mp, args.step,
                                 args.fed_schedule, args.p_q))

    def keep(rec):
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    if todo:
        # each record in a process of its own: one fake world each
        with ProcessPoolExecutor(
                min(len(todo), os.cpu_count() or 1, 8),
                mp_context=multiprocessing.get_context("spawn"),
                max_tasks_per_child=1) as ex:
            for fut in as_completed([ex.submit(_record, *j) for j in todo]):
                keep(fut.result())
    n_fail = sum(1 for r in results if "error" in r)
    print(f"[dryrun] complete: {len(results)} records, {n_fail} failures")


if __name__ == "__main__":
    main()
