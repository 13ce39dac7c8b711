"""The port's input specs and production mesh (``launch/specs.py``,
``configs/base.py::INPUT_SHAPES``, ``launch/mesh.py::make_production_mesh``)
against the JAX package's, on the CPU.

The reference's specs are ``jax.eval_shape`` trees (no device needed);
the port's are meta tensors.  Every leaf's shape and dtype must be equal,
in ``jax.tree.leaves`` order, for the ten transformer archs at full width
and the four input shapes.  Shardings read only a mesh's axis names and
sizes, so the reference runs on a ``jax.sharding.AbstractMesh`` of (16,
16) and (2, 16, 16) and the port on a stand-in with a ``DeviceMesh``'s
attributes; the spec tuples must equal the ``PartitionSpec``s.  The
production mesh needs a world of 256 or 512 ranks, which a ``"fake"``
process group gives in a subprocess of its own.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax._src.named_sharding import DuplicateSpecError

from repro.configs import base as JB
from repro.launch import specs as JS
from repro.sharding import rules as JR
from repro_torch.configs import base as B
from repro_torch.launch import specs as S
from repro_torch.sharding import rules as R
from repro_torch.utils.tree import leaves

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = tuple(a for a in B.ARCH_IDS if a != "fmnist_cnn")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class StandIn:
    """A ``DeviceMesh``'s attributes that the rules read."""

    def __init__(self, shape, names):
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)
        self.mesh_dim_names = tuple(names)

    def get_coordinate(self):
        return [0] * self.mesh.dim()


def _sig(tree_leaves):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in tree_leaves]


def _jax_spec(pspec, ndim):
    parts = tuple(pspec) + (None,) * (ndim - len(tuple(pspec)))
    return tuple(tuple(p) if isinstance(p, (list, tuple)) else p
                 for p in parts)


def _port_spec(spec):
    return tuple(tuple(p) if isinstance(p, (list, tuple)) else p
                 for p in spec)


def test_input_shapes_are_the_reference():
    assert list(B.INPUT_SHAPES) == list(JB.INPUT_SHAPES)
    for name, s in B.INPUT_SHAPES.items():
        j = JB.INPUT_SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)
    assert (S.WINDOW, S.PARAM_DTYPE) == (JS.WINDOW, torch.bfloat16)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    """Full width, bf16 and f32: every leaf's shape and dtype; nothing is
    allocated (meta tensors)."""
    for jd, td in ((JS.PARAM_DTYPE, S.PARAM_DTYPE),
                   (jax.numpy.float32, torch.float32)):
        want = _sig(jax.tree.leaves(JS.param_specs(JB.get_config(arch),
                                                   jd)))
        got_tree = S.param_specs(B.get_config(arch), td)
        assert all(x.device.type == "meta" for x in leaves(got_tree))
        assert _sig(leaves(got_tree)) == want


@pytest.mark.parametrize("shape", list(JB.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_decode_specs_match_reference(arch, shape):
    jcfg, cfg = JB.get_config(arch), B.get_config(arch)
    if JB.INPUT_SHAPES[shape].kind != "decode":
        assert _sig(leaves(S.batch_specs(cfg, shape))) == _sig(
            jax.tree.leaves(JS.batch_specs(jcfg, shape)))
        return
    for quantized in (False, True):
        jt, jc, jp, jr = JS.decode_specs(jcfg, shape, quantized=quantized)
        t, c, p, r = S.decode_specs(cfg, shape, quantized=quantized)
        assert r == jr
        assert _sig(leaves(t)) == _sig(jax.tree.leaves(jt))
        assert _sig(leaves(c)) == _sig(jax.tree.leaves(jc))
        assert _sig([p]) == _sig([jp])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_match_reference(arch, mesh):
    """``batch_shardings`` of the train/prefill batches and the decode
    tokens, ``cache_shardings`` of every decode cache with and without the
    sequence-sharded variant (the hybrid's extra stacked axis included):
    the port's spec tuples equal the reference's ``PartitionSpec``s."""
    shape, names = MESHES[mesh]
    jr, tr = JR.Rules(AbstractMesh(shape, names)), R.Rules(StandIn(shape,
                                                                    names))
    jcfg, cfg = JB.get_config(arch), B.get_config(arch)
    for sname, s in JB.INPUT_SHAPES.items():
        if s.kind != "decode":
            jb, tb = JS.batch_specs(jcfg, sname), S.batch_specs(cfg, sname)
            want = [_jax_spec(x.spec, y.ndim) for x, y in zip(
                jax.tree.leaves(JS.batch_shardings(jr, jb)),
                jax.tree.leaves(jb))]
            got = [_port_spec(x) for x in leaves(S.batch_shardings(tr, tb))]
            assert got == want, sname
            continue
        jt, jc, _, _ = JS.decode_specs(jcfg, sname)
        t, c, _, _ = S.decode_specs(cfg, sname)
        assert [_port_spec(x) for x in leaves(S.batch_shardings(tr, t))] \
            == [_jax_spec(x.spec, 2) for x in jax.tree.leaves(
                JS.batch_shardings(jr, jt))]
        for seq in (False, True):
            try:
                jsh = jax.tree.leaves(JS.cache_shardings(jr, jc,
                                                         seq_shard=seq))
            except DuplicateSpecError:
                # kv_seq and kv_heads both on 'model': both refuse
                with pytest.raises(ValueError, match="twice"):
                    S.cache_shardings(tr, c, seq_shard=seq)
                continue
            want = [_jax_spec(x.spec, y.ndim)
                    for x, y in zip(jsh, jax.tree.leaves(jc))]
            got = [_port_spec(x) for x in leaves(S.cache_shardings(
                tr, c, seq_shard=seq))]
            assert got == want, (sname, seq)


def _world_script(body: str) -> str:
    return textwrap.dedent('''
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch.mesh import make_production_mesh

        def world(n):
            if dist.is_initialized():
                dist.destroy_process_group()
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=n)
        ''') + textwrap.dedent(body)


def test_production_mesh_on_fake_worlds():
    """(16, 16) over a world of 256 ranks and (2, 16, 16) over 512, their
    axis names and rank grids the JAX package's; any other world, or the
    other mesh on one of them, raises a ValueError naming both sizes."""
    script = _world_script('''
        for n, pod in ((256, False), (512, True)):
            world(n)
            m = make_production_mesh(multi_pod=pod)
            print(n, tuple(m.mesh.shape), m.mesh_dim_names,
                  m.mesh.reshape(-1).tolist() == list(range(n)),
                  m.device_type)
            try:
                make_production_mesh(multi_pod=not pod)
            except ValueError as e:
                print("raised", "256" in str(e) and "512" in str(e))
        for n in (1, 4, 128, 1024):
            world(n)
            for pod in (False, True):
                try:
                    make_production_mesh(multi_pod=pod)
                    print("built", n)
                except ValueError as e:
                    print("raised", "256" in str(e) and "512" in str(e))
        dist.destroy_process_group()
        ''')
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=os.path.join(
                             ROOT, "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.split("\n")
    assert lines[0] == "256 (16, 16) ('data', 'model') True cpu"
    assert lines[1] == "raised True"
    assert lines[2] == "512 (2, 16, 16) ('pod', 'data', 'model') True cpu"
    assert lines[3] == "raised True"
    assert lines[4:12] == ["raised True"] * 8
