"""The port's checkpoint files (``repro_torch.checkpoint.io``) against the
JAX package's ``checkpoint/io.py`` and the ``msgpack`` package, on the CPU.

* The port's msgpack encoder writes the bytes of ``msgpack.packb(obj,
  default=_encode, use_bin_type=True)``, byte for byte: on the state blobs
  of live JAX engines (heap serial, batched cohort) and of a live JAX wave
  fleet, on the port's own blobs, and on edge values (the integer
  boundaries of every width, negatives, empty containers, bool and None,
  ndarrays of f32, i32, i64, u32 and bool).  Its decoder gives what
  ``msgpack.unpackb`` gives.
* Treedef strings equal ``str(jax.tree_util.tree_structure(tree))``.
* Files cross both ways: the JAX package's ``load_pytree``/``load_blob``
  read the port's files, and the port reads the JAX package's.
* ``load_pytree`` raises the JAX package's three ``ValueError``s, and
  ``load_sim_params`` reads engine and fleet blobs.

All of this is exact: the files carry bytes, integers and float64 values.
"""
import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.fl.fleet import FleetConfig as JFleetConfig
from repro.fl.fleet import build_fleet as jax_build_fleet
from repro.fl.protocols import make_setup as jax_make_setup
from repro.fl.protocols import make_sim as jax_make_sim
from repro.fl.simulator import SimConfig as JSimConfig
from repro.models import mlp as jmlp
from repro_torch.checkpoint import io as tio
from repro_torch.fl.protocols import make_setup, make_sim
from repro_torch.fl.simulator import SimConfig
from repro_torch.models import mlp as tmlp

from conftest import TINY_SETUP
from torch_threads import one_torch_thread  # noqa: F401


def _ref_packb(obj):
    return msgpack.packb(obj, default=jio._encode, use_bin_type=True)


def _ref_unpackb(data, raw=False):
    return msgpack.unpackb(data, object_hook=jio._decode, raw=raw,
                           strict_map_key=False)


def _assert_same(a, b, where="blob"):
    """Deep equality with ndarrays compared by dtype, shape and bytes."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), where
    else:
        assert a == b, where


def _jax_cfg(**kw):
    base = dict(method="teasq", n_devices=TINY_SETUP["n_devices"],
                c_fraction=0.1, mu=0.01, alpha=0.6, p_s=0.25, p_q=8,
                epochs=1, seed=3)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def blobs():
    """State blobs of live JAX runs and of the port: a heap serial engine,
    a batched cohort engine (with a deferred buffer and in-flight
    PendingTasks), and a two-job wave fleet (CNN and MLP)."""
    jdata, jparts, jw0 = jax_make_setup(**TINY_SETUP)
    w_np = {k: np.asarray(v) for k, v in jw0.items()}
    data, parts, w0 = make_setup(**TINY_SETUP, device="cpu",
                                 init_params=w_np)
    out = {}
    for name, kw in (("heap_serial", dict(scheduler="heap")),
                     ("batched_cohort", dict(scheduler="batched",
                                             cohort_size=4,
                                             codec="packed"))):
        jeng = jax_make_sim(jdata, jparts, jw0, JSimConfig(**_jax_cfg(**kw)))
        jeng.run(time_budget=2.0)
        out["jax_" + name] = jeng.state_dict()
        eng = make_sim(data, parts, w0, SimConfig(**_jax_cfg(**kw)),
                       device="cpu")
        eng.run(time_budget=2.0)
        out["port_" + name] = eng.state_dict()
    n = TINY_SETUP["n_devices"]
    fleet = jax_build_fleet(JFleetConfig(
        tasks=[JSimConfig(**_jax_cfg(cohort_size=4)),
               JSimConfig(**_jax_cfg(method="fedasync", task="fmnist_mlp",
                                     p_s=1.0, p_q=32))],
        n_devices=n, seed=3, scheduler="batched", handler_mode="wave",
        assigner="adaptive"), n_train=640, n_test=320)
    fleet.run(time_budget=2.0)
    out["jax_wave_fleet"] = fleet.state_dict()
    out["mlp_like"] = {k: np.asarray(v) for k, v in
                       fleet.runtimes[1].server.w.items()}
    return out


BLOBS = ["jax_heap_serial", "jax_batched_cohort", "jax_wave_fleet",
         "port_heap_serial", "port_batched_cohort"]


@pytest.mark.parametrize("name", BLOBS)
def test_blob_bytes_equal_msgpack(blobs, name):
    """The port's encoder against ``msgpack.packb`` on a real blob, and
    its decoder against ``msgpack.unpackb`` on those bytes."""
    want = _ref_packb(blobs[name])
    assert tio.packb(blobs[name]) == want
    _assert_same(tio.unpackb(want), _ref_unpackb(want))
    _assert_same(tio.unpackb(want, raw=True), _ref_unpackb(want, raw=True))


EDGE_VALUES = {
    "fixint": [0, 1, 127, -1, -32],
    "uint": [128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 63, 2 ** 64 - 1],
    "int": [-33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
            -2 ** 63],
    "float": [0.0, -0.5, 1e300, float("inf"), float("-inf"),
              np.float64(2.5)],
    "bool_none": [True, False, None, [None, True, False]],
    "str": ["", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "é" * 40,
            "b" * 70000],
    "bin": [b"", b"x" * 255, b"x" * 256, b"x" * 70000],
    "containers": [[], {}, (), [1] * 15, [1] * 16, [0] * 70000,
                   {str(i): i for i in range(15)},
                   {str(i): i for i in range(16)}, {1: "int key"},
                   {"t": (1, [2, {"x": ()}])}],
    "ndarray": [np.arange(6, dtype=np.float32).reshape(2, 3),
                np.array([-1, 2 ** 31 - 1], np.int32),
                np.array([-2 ** 63, 5], np.int64),
                np.array([0, 2 ** 32 - 1], np.uint32),
                np.array([True, False, True]),
                np.zeros((0, 4), np.float32), np.array(1.5, np.float32)],
}


@pytest.mark.parametrize("kind", sorted(EDGE_VALUES))
def test_edge_values_bytes_equal_msgpack(kind):
    for v in EDGE_VALUES[kind]:
        want = _ref_packb(v)
        assert tio.packb(v) == want, (kind, repr(v)[:40])
        for raw in (False, True):
            _assert_same(tio.unpackb(want, raw=raw),
                         _ref_unpackb(want, raw=raw), kind)


def test_unsupported_values_raise_like_msgpack():
    for v in (np.int64(3), np.bool_(True), np.float32(1.0), object()):
        with pytest.raises(TypeError):
            _ref_packb(v)
        with pytest.raises(TypeError):
            tio.packb(v)
    for v in (2 ** 64, -2 ** 63 - 1):
        with pytest.raises(OverflowError):
            _ref_packb(v)
        with pytest.raises(OverflowError):
            tio.packb(v)
    with pytest.raises(ValueError):
        tio.unpackb(_ref_packb([1, 2])[:-1])


def _trees():
    rng = np.random.RandomState(0)
    cnn = {k: rng.randn(*s).astype(np.float32) for k, s in
           (("b1", (32,)), ("b2", (32,)), ("bf1", (128,)), ("bf2", (10,)),
            ("conv1", (2, 2, 1, 32)), ("conv2", (2, 2, 32, 32)),
            ("fc1", (1568, 128)), ("fc2", (128, 10)))}
    mlp = {k: np.asarray(v) for k, v in
           jmlp.init_mlp(jax.random.PRNGKey(0)).items()}
    nested = {"b": np.array(2.0, np.float32),
              "a": {"y": np.arange(3, dtype=np.int32),
                    "x": [np.ones(2, np.float32), np.zeros(1, np.int64)]}}
    mixed = {"t": (np.ones(1, np.float32),), "n": None,
             "l": [np.ones(2, np.float32), {}], "e": []}
    return {"cnn": cnn, "mlp": mlp, "nested": nested, "mixed": mixed}


@pytest.mark.parametrize("name", ["cnn", "mlp", "nested", "mixed"])
def test_treedef_strings_equal_jax(name):
    tree = _trees()[name]
    leaves, treedef = tio._flatten(tree)
    assert treedef == str(jax.tree_util.tree_structure(tree))
    assert len(leaves) == len(jax.tree.leaves(tree))


@pytest.mark.parametrize("name", ["cnn", "mlp", "nested"])
def test_pytree_files_cross_both_ways(name, tmp_path):
    tree = _trees()[name]
    jpath, tpath = str(tmp_path / "jax.msgpack"), str(tmp_path / "t.msgpack")
    jio.save_pytree(jpath, tree)
    # the port's file from tensors is the JAX package's file, byte for byte
    torch_tree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    tio.save_pytree(tpath, torch_tree)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    got = tio.load_pytree(jpath, tree, device="cpu")
    back = jio.load_pytree(tpath, tree)
    for want, t, j in zip(jax.tree.leaves(tree), jax.tree.leaves(got),
                          jax.tree.leaves(back)):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), want)
        assert t.numpy().dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(j), want)


@pytest.mark.parametrize("name", BLOBS)
def test_blob_files_cross_both_ways(blobs, name, tmp_path):
    jpath, tpath = str(tmp_path / "jax.msgpack"), str(tmp_path / "t.msgpack")
    jio.save_blob(jpath, blobs[name])
    tio.save_blob(tpath, blobs[name])
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    _assert_same(tio.load_blob(jpath), jio.load_blob(jpath))
    _assert_same(jio.load_blob(tpath), tio.load_blob(tpath))


def test_load_pytree_raises_the_reference_errors(tmp_path):
    """The three ``ValueError``s of the JAX package's ``load_pytree``,
    on a like of tensors as on one of arrays."""
    path = str(tmp_path / "w.msgpack")
    tree = {"a": torch.ones(3, 2), "b": torch.arange(4, dtype=torch.int32)}
    tio.save_pytree(path, tree)
    out = tio.load_pytree(path, tree, device="cpu")
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"],
                                                            tree["b"])
    for load, like in ((tio.load_pytree, tree),
                       (jio.load_pytree, {k: v.numpy()
                                          for k, v in tree.items()})):
        kw = {"device": "cpu"} if load is tio.load_pytree else {}
        conv = (lambda v: v) if load is tio.load_pytree else np.asarray
        with pytest.raises(ValueError, match="treedef mismatch"):
            load(path, {"a": like["a"], "c": like["b"]}, **kw)
        with pytest.raises(ValueError, match="shape mismatch"):
            load(path, {"a": conv(torch.ones(2, 3)), "b": like["b"]}, **kw)
        with pytest.raises(ValueError, match="dtype mismatch"):
            load(path, {"a": like["a"],
                        "b": conv(torch.arange(4, dtype=torch.int64))},
                 **kw)


def test_load_sim_params_reads_engine_and_fleet_blobs(blobs, tmp_path):
    """Engine blobs (``core.server.w``) and fleet blobs (job j's
    ``tasks[j].server.w``), written by either package, against a ``like``
    of either kind; the errors of a bad task index or a foreign blob."""
    cnn_like = make_setup(**TINY_SETUP, device="cpu")[2]
    for name in ("jax_heap_serial", "port_batched_cohort"):
        path = str(tmp_path / f"{name}.msgpack")
        tio.save_blob(path, blobs[name])
        w = tio.load_sim_params(path, cnn_like, device="cpu")
        for k, leaf in zip(sorted(cnn_like),
                           blobs[name]["core"]["server"]["w"]):
            np.testing.assert_array_equal(w[k].numpy(), leaf)
        jw = jio.load_sim_params(path, {k: v.numpy()
                                        for k, v in cnn_like.items()})
        for k in w:
            np.testing.assert_array_equal(np.asarray(jw[k]), w[k].numpy())
    path = str(tmp_path / "fleet.msgpack")
    jio.save_blob(path, blobs["jax_wave_fleet"])
    mlp_like = tmlp.init_mlp(torch.Generator().manual_seed(0), device="cpu")
    for j, like in ((0, cnn_like), (1, mlp_like)):
        w = tio.load_sim_params(path, like, task=j, device="cpu")
        stored = blobs["jax_wave_fleet"]["tasks"][j]["server"]["w"]
        for k, leaf in zip(sorted(like), stored):
            np.testing.assert_array_equal(w[k].numpy(), leaf)
    np.testing.assert_array_equal(
        tio.load_sim_params(path, mlp_like, task=1, device="cpu")["w1"]
        .numpy(), blobs["mlp_like"]["w1"])
    with pytest.raises(ValueError, match="out of range"):
        tio.load_sim_params(path, cnn_like, task=2, device="cpu")
    with pytest.raises(ValueError, match="holds 4 weight leaves"):
        tio.load_sim_params(path, cnn_like, task=1, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        tio.load_sim_params(path, {**mlp_like, "w1": mlp_like["w1"].T},
                            task=1, device="cpu")
    with pytest.raises(ValueError, match="dtype mismatch"):
        tio.load_sim_params(path, {**mlp_like, "w1": mlp_like["w1"].double()},
                            task=1, device="cpu")
    other = str(tmp_path / "other.msgpack")
    tio.save_blob(other, {"x": 1})
    with pytest.raises(ValueError, match="not an engine or fleet"):
        tio.load_sim_params(other, cnn_like, device="cpu")


def test_loads_follow_the_device_rule(tmp_path, monkeypatch):
    """With no card and no device named, the loaders raise; they never
    fall back to the CPU on their own."""
    path = str(tmp_path / "w.msgpack")
    tree = {"a": np.ones(2, np.float32)}
    tio.save_pytree(path, tree)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tio.load_pytree(path, tree)
