"""The compression kernels vs the packed wire format, side by side, on the
PyTorch port: the kernel column is kernel B's block channel
(``ops.compress_roundtrip``), and the deterministic ``packed`` encode of
the codec runs kernel A on the card.

The twin of ``examples/compression_kernel_demo.py``; it runs on the card
unless given ``--device cpu``.

  PYTHONPATH=src python examples/torch_compression_kernel_demo.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.codecs import PackedBitstreamCodec
from repro_torch.core.compression import (compress_pytree, pytree_dense_bytes,
                                          pytree_wire_bytes)
from repro_torch.kernels.ops import compress_roundtrip
from repro_torch.models.cnn import init_cnn
from repro_torch.utils.tree import leaves, resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
args = ap.parse_args()
device = resolve_device(args.device)

w = init_cnn(torch.Generator().manual_seed(0), device=device)
dense = pytree_dense_bytes(w)

print("p_s    p_q   wire_KB  ratio   packed_KB  kernel_mse")
for p_s, p_q in [(1.0, 32), (0.5, 16), (0.25, 8), (0.1, 8), (0.05, 4)]:
    c = compress_pytree(w, p_s, p_q)
    wire = pytree_wire_bytes(c)
    # the real byte stream (codec API): len() must equal the analytic price
    packed = len(PackedBitstreamCodec(p_s, p_q).encode(w).payload)
    assert packed == wire, (packed, wire)
    # kernel path (block-local Top-K)
    mses = []
    for leaf in leaves(w):
        if leaf.numel() < 32:
            continue
        y = compress_roundtrip(leaf, p_s=p_s, bits=min(p_q, 8), block=4096)
        mses.append(float(torch.mean((y - leaf) ** 2)))
    print(f"{p_s:4.2f}  {p_q:4d}  {wire/1024:7.1f}  {dense/wire:5.1f}x  "
          f"{packed/1024:9.1f}  {np.mean(mses):.2e}")
