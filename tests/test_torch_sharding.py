"""The port's sharding rules (``sharding/rules.py``) against the JAX
package's, on the CPU.

``Rules.spec`` and ``param_shardings`` read only a mesh's axis names and
sizes, so the reference runs on a ``jax.sharding.AbstractMesh`` in this
process and the port on a stand-in with a ``DeviceMesh``'s attributes
(the rank grid, the axis names, a coordinate).  Specs must be equal:
the same mesh axes on the same dims, with the axes that do not divide a
dim dropped.  The rank's block (``local_block``) is held against numpy
slicing, and the collectives' world runs are in
``tests/test_torch_mesh.py``.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.sharding import rules as JR
from repro_torch.configs.base import ARCH_IDS
from repro_torch.sharding import rules as R
from repro_torch.utils.tree import leaves, paths

from torch_threads import one_torch_thread  # noqa: F401


class StandIn:
    """A ``DeviceMesh``'s attributes that the rules read."""

    def __init__(self, shape, names, coord=None):
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)
        self.mesh_dim_names = tuple(names)
        self.coord = coord or [0] * len(shape)

    def get_coordinate(self):
        return list(self.coord)


MESHES = {"single": ((2, 2), ("data", "model")),
          "wide": ((2, 4), ("data", "model")),
          "pod": ((2, 2, 2), ("pod", "data", "model"))}


def _pair(kind, **mapping):
    shape, names = MESHES[kind]
    return (JR.Rules(AbstractMesh(shape, names), mapping or None),
            R.Rules(StandIn(shape, names), mapping or None))


def _jax_spec(pspec, ndim):
    parts = tuple(pspec) + (None,) * (ndim - len(tuple(pspec)))
    return tuple(tuple(p) if isinstance(p, (list, tuple)) else p
                 for p in parts)


def _port_spec(spec):
    return tuple(tuple(p) if isinstance(p, (list, tuple)) else p
                 for p in spec)


SPEC_CASES = [
    (("batch", "seq", "d_model"), (8, 16, 32)),
    (("batch", "seq", "heads", None), (3, 16, 6, 8)),      # batch: no divide
    (("d_model", "heads"), (64, 9)),                       # smollm's 9 heads
    (("vocab", "d_model"), (1000, 64)),
    (("experts", None, None), (4, 8, 16)),
    (("fed_group", "stack", "ffn"), (4, 2, 12)),
    ((None, "kv_heads", "ssm_heads"), (5, 2, 4)),
    (("expert_cap", "classes", "conv"), (8, 10, 4)),
]


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("case", range(len(SPEC_CASES)))
def test_spec_matches_reference(kind, case):
    logical, shape = SPEC_CASES[case]
    jr, tr = _pair(kind)
    assert _port_spec(tr.spec(logical, shape)) == \
        _jax_spec(jr.spec(logical, shape), len(logical))
    # without a shape nothing is dropped
    assert _port_spec(tr.spec(logical)) == \
        _jax_spec(jr.spec(logical), len(logical))


def test_multi_pod_overrides_and_with_overrides():
    jr, tr = _pair("pod")
    assert tr.mapping == jr.mapping
    assert tr.mapping["batch"] == ("pod", "data")
    assert tr._mesh_size(("pod", "data")) == 4 == jr._mesh_size(
        ("pod", "data"))
    for kw in ({"batch": None, "seq": None},
               {"batch": "model", "heads": None, "experts": None}):
        j2, t2 = jr.with_overrides(**kw), tr.with_overrides(**kw)
        assert t2.mapping == j2.mapping and t2.mesh is tr.mesh
        for logical, shape in SPEC_CASES:
            assert _port_spec(t2.spec(logical, shape)) == \
                _jax_spec(j2.spec(logical, shape), len(logical))
    assert tr.mapping["batch"] == ("pod", "data")     # the parent unchanged
    jm, tm = _pair("single", experts=None, vocab="data")
    assert tm.mapping == jm.mapping


@pytest.mark.parametrize("path,ndim", [
    ("embed", 2), ("layers/attn/wq", 3), ("layers/moe/e_gate", 4),
    ("layers/moe/e_gate", 3), ("layers/ssm/a_log", 3),
    ("layers/ssm/conv_w", 2), ("layers/norm1", 2), ("conv1", 4),
    ("fc1", 2), ("router", 1), ("blocks/0/mamba/in_proj", 4)])
def test_logical_axes_for_matches_reference(path, ndim):
    assert R.logical_axes_for(path, ndim) == JR.logical_axes_for(path, ndim)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_match_reference(arch):
    """Every smoke config's parameter tree (its shapes, from the JAX
    package's ``init_model``), on the single-pod and the multi-pod mesh:
    the port's spec of each leaf equals the reference's, leaf by leaf in
    ``jax.tree.leaves`` order."""
    cfg = jax_smoke_config(arch)
    shapes = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0),
                                                  cfg))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    tree = {}
    for path, leaf in flat:
        node = tree
        keys = [str(p.key) for p in path]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(leaf.shape, device="meta")
    for kind in ("single", "pod"):
        jr, tr = _pair(kind)
        want = [_jax_spec(s.spec, len(leaf.shape)) for s, (_, leaf) in zip(
            jax.tree.leaves(JR.param_shardings(jr, shapes),
                            is_leaf=lambda x: hasattr(x, "spec")), flat)]
        got = [_port_spec(s) for s in R.param_specs(tr, tree)]
        assert got == want
        nested = R.param_shardings(tr, tree)
        assert paths(nested) == paths(tree)
        assert leaves(nested) == R.param_specs(tr, tree)


def test_active_rules_nest_and_shard_is_identity():
    _, tr = _pair("single")
    assert R.active_rules() is None
    x = torch.arange(6.0)
    with R.use_rules(tr) as r:
        assert R.active_rules() is tr is r
        with R.use_rules(None):
            assert R.active_rules() is None
        assert R.active_rules() is tr
        assert R.shard(x, "batch") is x
    assert R.active_rules() is None


@pytest.mark.parametrize("kind", ["single", "wide", "pod"])
def test_local_block_cuts_like_the_spec(kind):
    """Each coordinate's block, against numpy slicing by the row-major
    index along the spec's axes."""
    shape, names = MESHES[kind]
    x = torch.arange(8 * 12 * 4, dtype=torch.float32).reshape(8, 12, 4)
    rules = R.Rules(StandIn(shape, names))
    spec = rules.spec(("batch", "heads", None), x.shape)
    for coord in np.ndindex(*shape):
        mesh = StandIn(shape, names, list(coord))
        got = R.local_block(x, spec, mesh)
        want = x.numpy()
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            i, n = R.axis_index(mesh, ax)
            size = want.shape[dim] // n
            want = np.take(want, range(i * size, (i + 1) * size), axis=dim)
        np.testing.assert_array_equal(got.numpy(), want)
    assert R.axes_size(StandIn(shape, names), spec) == int(np.prod(
        [R.axis_index(StandIn(shape, names), ax)[1] for ax in spec if ax]))


@pytest.mark.parametrize("kind", ["single", "wide", "pod"])
def test_param_blocks_are_the_specs_blocks(kind):
    """At each coordinate ``param_blocks`` gives every leaf's block under
    ``param_specs``: a split leaf's block is a tensor of its own, a leaf
    held whole is the leaf itself (whisper's vocabulary of 515 divides no
    model axis), and ``block_specs`` gives the whole leaves' specs back
    from the blocks; a tensor it did not cut raises."""
    import dataclasses
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import transformer as T
    shape, names = MESHES[kind]
    for arch, vocab in (("qwen3_1_7b", None), ("whisper_tiny", 515)):
        cfg = get_smoke_config(arch)
        if vocab:
            cfg = dataclasses.replace(cfg, vocab=vocab)
        params = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
        whole = 0
        for coord in np.ndindex(*shape):
            rules = R.Rules(StandIn(shape, names, list(coord)))
            specs = R.param_specs(rules, params)
            blocks = R.param_blocks(params, rules)
            assert R.block_specs(rules, blocks) == specs
            for x, b, sp in zip(leaves(params), leaves(blocks), specs):
                assert torch.equal(b, R.local_block(x, sp, rules.mesh))
                if R.axes_size(rules.mesh, sp) > 1:
                    assert b.untyped_storage().data_ptr() != \
                        x.untyped_storage().data_ptr()
                else:
                    assert b is x
                    whole += x.dim() == 2 and x.shape[0] == vocab
        assert whole > 0 if vocab else whole == 0
    rules = R.Rules(StandIn(shape, names))
    with pytest.raises(ValueError, match="no block that param_blocks cut"):
        R.block_specs(rules, {"wq": torch.zeros(3, 8)})
