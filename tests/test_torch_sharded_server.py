"""The port's sharded server (``SERVERS["sharded"]``) against the JAX
package's, on the CPU: the twin of ``tests/test_sharded_server.py``.

* The per-element program of a shard (the K-term sum and the Eq. 10
  merge, ``_stacked_merge``) within 1 ulp of the JAX package's shard
  body given the same Eq. 6-9 scalars: XLA's CPU backend computes it as
  a chain of fused multiply-adds, and so does the port.
* ``aggregate_cache_sharded_ref`` (the mesh-free column-block replay)
  within 1 ulp of the port's own stacked form (the same per-element
  program on a column block) over cache sizes and shard counts that
  force the zero pad, and against the JAX package's replay within the
  stacked form's tolerance (rtol 1e-5, atol 1e-6, as
  ``tests/test_torch_batched.py`` holds it): the scalars of Eqs. 6-9 come
  from K-term sums that XLA and torch order differently (one ulp of a
  weight), and the merge of nearly cancelling terms can widen that to
  hundreds of ulps of a small result.
* ``ShardedTeasqServer`` outside a world (or at ``shards=1``) builds no
  mesh and is the parent's exact path: engine histories bit-identical to
  ``server="single"``.
* Worlds of 2 and 4 gloo processes (``launch.mesh.spawn_world``, a file
  store under ``tmp_path``) against the reference's ``shard_map`` on 4
  host devices, run once per module in a subprocess beside them: the same
  entry stream through both receive paths, every rank's weights within
  1 ulp of the port's stacked form on the same stream, within the
  stacked tolerance of the reference's, and equal to every other rank's
  bit for bit;
  in the world of 4 also 2 shards (each pair of ranks reduces the whole
  vector) and whole engine runs whose time, round and byte columns equal
  ``server="single"``'s.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import staleness as JS
from repro_torch.core import staleness as S
from repro_torch.core.server import (SERVERS, ServerConfig,
                                     ShardedTeasqServer, TeasqServer,
                                     make_server)
from repro_torch.launch.mesh import spawn_world
from repro_torch.utils.tree import from_numpy, leaves, to_numpy

from torch_threads import one_torch_thread  # noqa: F401

try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:        # the fixed grid below still pins the parity
    HAVE_HYPOTHESIS = False

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def max_ulp_diff(a, b):
    """Largest per-element distance in f32 units in the last place (the
    bit patterns mapped to a monotonic integer order, -0.0 == +0.0)."""
    ia = np.asarray(a, np.float32).ravel().view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).ravel().view(np.int32).astype(np.int64)
    la = np.where(ia >= 0, ia, np.int64(-2 ** 31) - ia)
    lb = np.where(ib >= 0, ib, np.int64(-2 ** 31) - ib)
    return int(np.abs(la - lb).max()) if la.size else 0


def _tree_ulp(t_a, t_b):
    return max(max_ulp_diff(a, b) for a, b in zip(t_a, t_b))


def _rand_tree(rng, shapes=((13, 7), (5,))):
    return {f"l{i}": rng.randn(*sh).astype(np.float32)
            for i, sh in enumerate(shapes)}


def _rand_cache(rng, size, shapes=((13, 7), (5,))):
    return [(_rand_tree(rng, shapes), int(rng.randint(0, 5)),
             int(rng.randint(1, 200))) for _ in range(size)]


def _port(tree):
    return from_numpy(tree, "cpu")


def _port_cache(cache):
    return [(_port(u), h, n) for u, h, n in cache]


def _np_leaves(tree):
    return [np.asarray(x) for x in leaves(to_numpy(tree))]


def _jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# ----------------------------------------------------------------------
# registry + construction
# ----------------------------------------------------------------------
def test_servers_registry():
    assert SERVERS["single"] is TeasqServer
    assert SERVERS["sharded"] is ShardedTeasqServer
    cfg = ServerConfig(n_devices=10)
    w0 = {"w": torch.zeros(3)}
    assert type(make_server("single", w0, cfg)) is TeasqServer
    srv = make_server("sharded", w0, cfg, shards=1)
    assert type(srv) is ShardedTeasqServer
    with pytest.raises(ValueError, match="unknown server"):
        make_server("bogus", w0, cfg)


def test_degenerate_sharded_has_no_mesh():
    """shards=1, or a process outside any world, builds no mesh and runs
    no collective: both aggregation hooks are the parent's."""
    for shards in (0, 1, 4):
        srv = make_server("sharded", {"w": torch.zeros(3)},
                          ServerConfig(n_devices=10), shards=shards)
        assert srv.n_shards == 1
        assert srv.mesh is None and srv._agg is None


# ----------------------------------------------------------------------
# the mesh-free column-block replay against the JAX package's
# ----------------------------------------------------------------------
def _assert_stacked_close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cache_size", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("n", [5, 24, 96])
def test_shard_program_matches_jax(cache_size, n):
    """One shard's flat Eqs. 7 and 10 from the JAX package's scalars: the
    port's per-element program within 1 ulp of the jitted shard body."""
    rng = np.random.RandomState(cache_size * 100 + n)
    wg = rng.randn(n).astype(np.float32)
    stk = rng.randn(cache_size, n).astype(np.float32)
    st = rng.randint(0, 7, cache_size).astype(np.float32)
    ns = rng.randint(1, 200, cache_size).astype(np.float32)
    want = JS._sharded_body_jit(wg, stk, st, ns, np.float32(0.6),
                                np.float32(0.5))
    wts = jax.jit(JS.stacked_staleness_weights)(st, ns, np.float32(0.5))
    a_t = jax.jit(lambda s, al, a: al * (s.mean() + 1.0) ** (-a))(
        st, np.float32(0.6), np.float32(0.5))
    got = S._stacked_merge(torch.from_numpy(wg), torch.from_numpy(stk),
                           torch.from_numpy(np.array(wts)),
                           torch.from_numpy(np.array(a_t)))
    assert max_ulp_diff(got.numpy(), np.asarray(want)) <= 1


@pytest.mark.parametrize("cache_size", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_sharded_ref_matches_stacked_and_jax(cache_size, n_shards):
    rng = np.random.RandomState(cache_size * 10 + n_shards)
    w0 = _rand_tree(rng)
    cache = _rand_cache(rng, cache_size)
    got = S.aggregate_cache_sharded_ref(_port(w0), _port_cache(cache), t=6,
                                        alpha=0.6, a=0.5, n_shards=n_shards)
    stacked = S.aggregate_cache_stacked(_port(w0), _port_cache(cache), t=6,
                                        alpha=0.6, a=0.5)
    assert _tree_ulp(_np_leaves(got), _np_leaves(stacked)) <= 1
    want = JS.aggregate_cache_sharded_ref(w0, cache, t=6, alpha=0.6, a=0.5,
                                          n_shards=n_shards)
    _assert_stacked_close(_np_leaves(got), _jax_leaves(want))


def test_sharded_ref_close_to_serial_kernel():
    """Against the serial K-tuple form the stacked reduction reassociates:
    allclose at the wave-mode tolerance."""
    rng = np.random.RandomState(0)
    w0 = _rand_tree(rng)
    cache = _rand_cache(rng, 4)
    a = S.aggregate_cache(_port(w0), _port_cache(cache), t=6, alpha=0.6,
                          a=0.5)
    b = S.aggregate_cache_sharded_ref(_port(w0), _port_cache(cache), t=6,
                                      alpha=0.6, a=0.5, n_shards=3)
    for la, lb in zip(_np_leaves(a), _np_leaves(b)):
        np.testing.assert_allclose(la, lb, rtol=1e-5, atol=1e-6)


if HAVE_HYPOTHESIS:
    @settings(max_examples=25, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(data=st.data(),
           cache_size=st.integers(min_value=1, max_value=8),
           n_shards=st.integers(min_value=1, max_value=4),
           t=st.integers(min_value=0, max_value=30),
           alpha=st.floats(min_value=0.1, max_value=1.0),
           seed=st.integers(min_value=0, max_value=99))
    def test_sharded_ref_property(data, cache_size, n_shards, t, alpha,
                                  seed):
        """Property form of the grid: cache sizes, staleness vectors, leaf
        shapes (odd sizes exercise the pad) and shard counts; 1 ulp of
        the port's stacked form, the stacked tolerance of the JAX
        package's replay."""
        rng = np.random.RandomState(seed)
        shapes = ((data.draw(st.integers(1, 9), label="rows"),
                   data.draw(st.integers(1, 9), label="cols")),
                  (data.draw(st.integers(1, 7), label="bias"),))
        w0 = _rand_tree(rng, shapes)
        cache = [(_rand_tree(rng, shapes),
                  data.draw(st.integers(0, t), label=f"h{i}"),
                  data.draw(st.integers(1, 500), label=f"n{i}"))
                 for i in range(cache_size)]
        got = S.aggregate_cache_sharded_ref(_port(w0), _port_cache(cache),
                                            t=t, alpha=alpha, a=0.5,
                                            n_shards=n_shards)
        stacked = S.aggregate_cache_stacked(_port(w0), _port_cache(cache),
                                            t=t, alpha=alpha, a=0.5)
        assert _tree_ulp(_np_leaves(got), _np_leaves(stacked)) <= 1
        want = JS.aggregate_cache_sharded_ref(w0, cache, t=t, alpha=alpha,
                                              a=0.5, n_shards=n_shards)
        _assert_stacked_close(_np_leaves(got), _jax_leaves(want))


# ----------------------------------------------------------------------
# the degenerate server through the engine
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    from repro_torch.fl.protocols import make_setup
    return make_setup(8, True, 3, 640, 320, device="cpu")


@pytest.mark.parametrize("method", ["teasq", "fedasync"])
def test_engine_degenerate_sharded_bit_identical(method, tiny):
    from repro_torch.fl.protocols import run_method
    runs = [run_method(method, *tiny, time_budget=4.0, epochs=1, seed=3,
                       server=server, device="cpu")
            for server in ("single", "sharded")]
    assert runs[0] == runs[1] and len(runs[0]) >= 2


# ----------------------------------------------------------------------
# worlds of 2 and 4 against the reference's shard_map
# ----------------------------------------------------------------------
STREAM = r"""
import numpy as np
rng = np.random.RandomState(0)
def tree():
    return {"w1": rng.randn(13, 7).astype(np.float32),
            "b": rng.randn(5).astype(np.float32)}
W0 = tree()
ENTRIES = [(tree(), max(0, i % 4 - 1), 10 + 3 * i) for i in range(8)]
GAMMA = 0.3                                  # K = 3 of 10 devices
"""

JAX_SCRIPT = STREAM + r"""
import os, sys
import jax
from repro.core.server import ServerConfig, make_server
assert len(jax.devices()) == 4, jax.devices()
out = {}
for mesh in (2, 4):
    for wave in (False, True):
        srv = make_server("sharded", dict(W0), ServerConfig(10, gamma=GAMMA),
                          shards=mesh)
        assert srv.n_shards == mesh
        srv.active = len(ENTRIES)
        done = (srv.receive_many(list(ENTRIES)) if wave
                else [srv.receive(*e) for e in ENTRIES])
        for i, leaf in enumerate(jax.tree.leaves(srv.w)):
            out[f"{mesh}-{int(wave)}-{i}"] = np.asarray(leaf)
        out[f"{mesh}-{int(wave)}-done"] = np.asarray(done + [srv.t])
np.savez(sys.argv[1], **out)
"""

WORLD_SCRIPT = STREAM + r"""
import os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.core.server import ServerConfig, make_server
from repro_torch.launch.mesh import init_world
from repro_torch.utils.tree import from_numpy, leaves
init_world("gloo")
rank, world = dist.get_rank(), dist.get_world_size()
out = {}
from repro_torch.core.server import TeasqServer
for mesh in sorted({2, world}):
    for wave in (False, True):
        if mesh == 2 and not wave:
            # the port's stacked form on the same stream, for the 1-ulp
            # comparison (each cache fill through aggregate_cache_stacked)
            ctl = TeasqServer(from_numpy(W0, "cpu"),
                              ServerConfig(10, gamma=GAMMA))
            ctl.active = len(ENTRIES)
            ctl.receive_many([(from_numpy(u, "cpu"), h, n)
                              for u, h, n in ENTRIES])
            for i, leaf in enumerate(leaves(ctl.w)):
                out[f"stacked-{i}"] = leaf.numpy()
        srv = make_server("sharded", from_numpy(W0, "cpu"),
                          ServerConfig(10, gamma=GAMMA), shards=mesh)
        assert srv.n_shards == mesh
        srv.active = len(ENTRIES)
        entries = [(from_numpy(u, "cpu"), h, n) for u, h, n in ENTRIES]
        done = (srv.receive_many(entries) if wave
                else [srv.receive(*e) for e in entries])
        for i, leaf in enumerate(leaves(srv.w)):
            out[f"{mesh}-{int(wave)}-{i}"] = leaf.numpy()
        out[f"{mesh}-{int(wave)}-done"] = np.asarray(done + [srv.t])
if world == 4:
    try:                    # 3 shards do not divide a world of 4
        make_server("sharded", from_numpy(W0, "cpu"), ServerConfig(10),
                    shards=3)
        out["shards-3"] = np.asarray(0)
    except ValueError:
        out["shards-3"] = np.asarray(1)
    # whole engine runs: the sharded aggregation moves no event
    from repro_torch.fl.protocols import make_setup, run_method
    data, parts, w0 = make_setup(8, True, 3, 320, 160, device="cpu")
    for method in ("teasq", "fedasync"):
        for server in ("single", "sharded"):
            h = run_method(method, data, parts, w0, time_budget=2.0, seed=3,
                           epochs=1, server=server, server_shards=world,
                           device="cpu")
            out[f"engine-{method}-{server}"] = np.asarray(
                [(e.time, e.round, e.bytes_up, e.bytes_down, e.accuracy)
                 for e in h], np.float64)
np.savez(os.path.join(sys.argv[1], f"rank{rank}.npz"), **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference on 4 host devices (a subprocess) beside the port's
    worlds of 2 and 4 -> (reference outputs, {world: [rank outputs]})."""
    tmp = tmp_path_factory.mktemp("sharded_server")
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    ref = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT,
                            str(tmp / "ref.npz")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    ports = {}
    try:
        for world in (2, 4):
            d = tmp / f"world{world}"
            d.mkdir()
            spawn_world([sys.executable, "-c", WORLD_SCRIPT, str(d)], world,
                        timeout=400, env={**os.environ, "PYTHONPATH": SRC},
                        store_dir=str(d))
            ports[world] = [dict(np.load(d / f"rank{r}.npz"))
                            for r in range(world)]
        out, err = ref.communicate(timeout=400)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, out + err
    return dict(np.load(tmp / "ref.npz")), ports


@pytest.mark.parametrize("world,mesh", [(2, 2), (4, 2), (4, 4)])
@pytest.mark.parametrize("wave", [False, True])
def test_world_matches_shard_map(worlds, world, mesh, wave):
    """Every rank: the reference's flags and round count, within 1 ulp of
    the port's stacked form on the same stream, within the stacked
    tolerance of the reference's mesh of the same width (2 shards in a
    world of 4: each pair of ranks reduces, all four end equal), and equal
    to rank 0 bit for bit."""
    ref, ports = worlds
    key = f"{mesh}-{int(wave)}"
    for r, got in enumerate(ports[world]):
        np.testing.assert_array_equal(got[f"{key}-done"], ref[f"{key}-done"])
        for i in range(2):
            assert max_ulp_diff(got[f"{key}-{i}"], got[f"stacked-{i}"]) \
                <= 1, (r, i)
            np.testing.assert_allclose(got[f"{key}-{i}"], ref[f"{key}-{i}"],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(got[f"{key}-{i}"],
                                          ports[world][0][f"{key}-{i}"])


def test_world_shards_must_divide_the_world(worlds):
    _, ports = worlds
    assert all(int(r["shards-3"]) == 1 for r in ports[4])


def test_world_engine_keeps_the_timeline(worlds):
    """teasq and fedasync in the world of 4: the time, round and byte
    columns of ``server="sharded"`` equal ``"single"``'s, accuracy within
    0.05 (the reduction's order), and every rank's history is rank 0's."""
    _, ports = worlds
    for method in ("teasq", "fedasync"):
        a = ports[4][0][f"engine-{method}-single"]
        b = ports[4][0][f"engine-{method}-sharded"]
        assert a.shape == b.shape and a.shape[0] >= 2
        np.testing.assert_array_equal(a[:, :4], b[:, :4])
        assert np.abs(a[:, 4] - b[:, 4]).max() <= 0.05
        for got in ports[4][1:]:
            np.testing.assert_array_equal(got[f"engine-{method}-sharded"], b)
