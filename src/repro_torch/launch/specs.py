"""Meta-tensor input specs for every (arch x input shape) pair.

The JAX package's ``launch/specs.py``.  A spec there is a
``jax.ShapeDtypeStruct``; here it is a tensor on the ``meta`` device: a
shape, a dtype and strides, and no data.  Nothing is allocated and
nothing is drawn: ``param_specs`` runs the port's ``init_model`` with no
generator on that device, so the tree is the model's own, in
``jax.tree.leaves`` order.  Modality frontends are stubbed as in the JAX package: the batches carry
precomputed frame and patch embeddings.

Shardings are the port's spec tuples (``Rules.spec``), one mesh axis (or
a tuple of them, or None) per dim, where the JAX package gives a
``NamedSharding``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.models import transformer as T
from repro_torch.sharding.rules import Rules, as_axes, use_rules
from repro_torch.utils.tree import leaves, paths, tree_map, unflatten

PARAM_DTYPE = torch.bfloat16
WINDOW = 8192                  # sliding-window size for long_500k decode

META = torch.device("meta")


def param_specs(cfg: ModelConfig, dtype=PARAM_DTYPE):
    """The parameter tree on the meta device (no allocation, no draw)."""
    with META:
        return T.init_model(cfg, None, device=META, dtype=dtype)


def batch_specs(cfg: ModelConfig, shape_name: str,
                n_groups: int = 1) -> Dict[str, torch.Tensor]:
    """The training / prefill batch: int32 tokens, and the stubbed frame
    (encoder-decoder) or patch (VLM) embeddings."""
    s = INPUT_SHAPES[shape_name]
    B = s.global_batch
    with META:
        out = {"tokens": torch.empty((B, s.seq_len), dtype=torch.int32)}
        if cfg.is_encoder_decoder:
            out["frames"] = torch.empty((B, cfg.enc_seq, cfg.d_model),
                                        dtype=PARAM_DTYPE)
        if cfg.n_patches:
            out["patches"] = torch.empty((B, cfg.n_patches, cfg.d_model),
                                         dtype=PARAM_DTYPE)
    return out


def decode_specs(cfg: ModelConfig, shape_name: str, quantized: bool = False
                 ) -> Tuple[Dict[str, torch.Tensor], Any, torch.Tensor,
                            bool]:
    """-> (token batch, cache tree, pos (a 0-d int32), rolling).  The
    cache is a rolling window of ``WINDOW`` slots at ``long_500k`` for
    every arch with attention."""
    s = INPUT_SHAPES[shape_name]
    B = s.global_batch
    rolling = shape_name == "long_500k" and not cfg.is_ssm_only
    cache_len = min(s.seq_len, WINDOW) if rolling else s.seq_len
    with META, use_rules(None):    # the whole cache, as every spec here
        cache = T.init_decode_state(cfg, B, cache_len, PARAM_DTYPE,
                                    device=META, rolling=rolling,
                                    quantized=quantized)
        tok = {"tokens": torch.empty((B, 1), dtype=torch.int32)}
        pos = torch.empty((), dtype=torch.int32)
    return tok, cache, pos, rolling


# ----------------------------------------------------------------------
# shardings
# ----------------------------------------------------------------------
def batch_shardings(rules: Rules, batch):
    """Each batch leaf's spec: its first dim over ``batch``."""
    return tree_map(lambda x: rules.spec(
        ("batch",) + (None,) * (x.dim() - 1), x.shape), batch)


_CACHE_LOGICAL = {
    "k": ("stack", "batch", "seq", "kv_heads", "head_dim"),
    "v": ("stack", "batch", "seq", "kv_heads", "head_dim"),
    "k_scale": ("stack", "batch", "seq", "kv_heads"),
    "v_scale": ("stack", "batch", "seq", "kv_heads"),
    "xk": ("stack", "batch", "seq", "kv_heads", "head_dim"),
    "xv": ("stack", "batch", "seq", "kv_heads", "head_dim"),
    "state": ("stack", "batch", "ssm_heads", None, None),
    "conv": ("stack", "batch", None, None),
}

# sequence-sharded KV variant: cache seq axis on the 'model' mesh axis
_CACHE_LOGICAL_SEQSHARD = dict(
    _CACHE_LOGICAL,
    k=("stack", "batch", "kv_seq", "kv_heads", "head_dim"),
    v=("stack", "batch", "kv_seq", "kv_heads", "head_dim"),
)


def cache_shardings(rules: Rules, cache, seq_shard: bool = False):
    """Each cache leaf's spec, by its key; the hybrid's SSM leaves carry
    one more stacked axis.  A spec that names a mesh axis twice (the
    sequence-sharded cache of an arch whose KV heads also split over
    ``model``) raises, as the JAX package's ``NamedSharding`` does."""
    table = _CACHE_LOGICAL_SEQSHARD if seq_shard else _CACHE_LOGICAL
    if seq_shard:
        rules = rules.with_overrides(kv_seq="model")
    names = paths(cache)
    out = []
    for path, leaf in zip(names, leaves(cache)):
        logical = table.get(path[-1], (None,) * leaf.dim())
        if len(logical) != leaf.dim():  # hybrid: extra stacked axis
            logical = ("stack",) + tuple(logical)
        spec = rules.spec(logical[:leaf.dim()], leaf.shape)
        axes = [a for ax in spec for a in as_axes(ax)]
        if len(set(axes)) != len(axes):   # as NamedSharding refuses it
            raise ValueError(f"the cache leaf {'/'.join(path)} would name "
                             f"a mesh axis twice: {spec}")
        out.append(spec)
    return unflatten(names, out)
