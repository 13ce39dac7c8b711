"""How the port's ``gather_q`` federated round is held against the JAX
package's, shared by the port's fed-round tests.

A whole ``gather_q`` round cannot agree bit for bit: the local steps
agree only within float noise, and that noise can flip a quantization
level (moving an element by one step, ``scale / L`` of its group row) or
move a group's threshold across a value (one package keeps it, the other
drops it: off by at most the threshold plus a step).  So every element is
held within the threshold plus a step of its leaf, and at most
``FLIP_SHARE`` of all elements lie past one step or past ``F32_TOL``.

``quant_stats`` gives the reference's per-leaf scale and threshold from
its own deltas; call it inside the ``jax.jit`` that runs the reference
round, so that one compile serves both.  ``port_quant_stats`` gives them
from the port's deltas, which equal the reference's within float noise,
without compiling the reference's local steps once more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import fed_step as J
from repro_torch.core import fed_step as F
from repro_torch.utils.tree import leaves, tree_map

F32_TOL = 1e-5
FLIP_SHARE = 1e-3


def quant_stats(loss, fed):
    """-> ``stats(w, batch)``: per leaf, (the largest group scale of the
    reference's deltas, the largest group threshold), as arrays."""
    G, E = fed.n_groups, fed.local_steps

    def split(x):
        return x.reshape((G, E, x.shape[0] // (G * E)) + x.shape[1:])

    def stats(w, batch):
        wl, _ = jax.vmap(lambda b: J._group_local_train(w, b, loss, fed))(
            jax.tree.map(split, batch))
        out = []
        for a, w0 in zip(jax.tree.leaves(wl), jax.tree.leaves(w)):
            rows = (a - w0[None]).reshape(G, -1)
            _, sc = jax.vmap(lambda x: J.compress_delta(x, fed))(rows)
            thr = jax.vmap(lambda x: J.approx_topk_threshold(
                jnp.abs(x), fed.p_s, fed.threshold_iters))(rows)
            out.append((jnp.max(sc), jnp.max(thr)))
        return out

    return stats


def port_quant_stats(loss, fed, w, batch):
    """``quant_stats`` from the port's deltas (``loss``, ``fed``, ``w`` and
    ``batch`` of the port)."""
    G, E = fed.n_groups, fed.local_steps
    wl, _ = torch.func.vmap(lambda b: F._group_local_train(w, b, loss, fed))(
        tree_map(lambda x: x.reshape(
            (G, E, x.shape[0] // (G * E)) + x.shape[1:]), batch))
    out = []
    for a, w0 in zip(leaves(wl), leaves(w)):
        rows = (a - w0[None]).reshape(G, -1)
        sc = max(float(F.compress_delta(r, fed)[1]) for r in rows)
        thr = max(float(F.approx_topk_threshold(
            torch.abs(r), fed.p_s, fed.threshold_iters)) for r in rows)
        out.append((sc, thr))
    return out


def assert_gather_q_close(got, want, stats, p_q):
    """``got``/``want``: the two rounds' params as lists of numpy leaves;
    ``stats``: ``quant_stats``'s output for the same round."""
    L = 2 ** (p_q - 1) - 1
    far = past_step = total = 0
    for g, w, (sc, thr) in zip(got, want, stats):
        q, thr = float(sc) / L, float(thr)
        err = np.abs(g - w)
        assert float(err.max()) <= (thr + q) * (1 + 1e-6), \
            (float(err.max()), thr, q)
        past_step += int((err > q * (1 + 1e-6)).sum())
        far += int((err > F32_TOL).sum())
        total += err.size
    assert past_step <= FLIP_SHARE * total, (past_step, total)
    assert far <= FLIP_SHARE * total, (far, total)
