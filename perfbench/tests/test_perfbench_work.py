"""The frozen work counts against counts by hand at tiny shapes."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.work import kernels as K  # noqa: E402
from perfbench.work.model_flops import (matmul_params,  # noqa: E402
                                        nonparam_flops_per_token,
                                        train_flops_per_token)
from perfbench.work.peaks import F32_FLOPS, HBM_BYTES, TF32_FLOPS  # noqa

MAMBA = {"n_layers": 2, "d_model": 8, "vocab": 10, "ssm_state": 4,
         "ssm_head_dim": 4, "ssm_expand": 2, "ssm_chunk": 4}
LLAMA = {"n_layers": 3, "d_model": 6, "vocab": 11, "n_heads": 3,
         "n_kv_heads": 1, "d_ff": 5}


def test_mamba2_flops_by_hand():
    # d_inner 16, heads 4: in_proj 8 x (32 + 8 + 4), out_proj 16 x 8
    assert matmul_params(MAMBA) == 2 * (8 * 44 + 16 * 8) + 10 * 8
    # per token and layer: L N + L H P + 4 N H P = 16 + 64 + 256
    assert nonparam_flops_per_token(MAMBA, 8) == 2 * (4 * 4 + 4 * 4 * 4
                                                      + 4 * 4 * 4 * 4)
    assert train_flops_per_token(MAMBA, 8) == 6 * 1040 + 3 * 672


def test_llama_flops_by_hand():
    # head dim 2: wq, wo 6 x 6; wk, wv 6 x 2; SwiGLU 3 x 6 x 5
    assert matmul_params(LLAMA) == 3 * (36 + 36 + 12 + 12 + 90) + 11 * 6
    # QK and PV on the causal half: 2 S H hd a token and layer
    assert nonparam_flops_per_token(LLAMA, 7) == 3 * 2 * 7 * 6
    assert train_flops_per_token(LLAMA, 7) == 6 * 624 + 3 * 252


def test_matmul_params_count_the_references_product_weights():
    import torch
    from perfbench.reference import llama, mamba2
    from perfbench.reference.fed_round import flatten
    gen = torch.Generator().manual_seed(0)
    m = dict(MAMBA, ssm_conv_width=4, norm_eps=1e-5)
    p = dict(flatten(mamba2.init_params(m, gen)))
    assert matmul_params(MAMBA) == sum(
        p[k].numel() for k in ("embed", "layers.ssm.in_proj",
                               "layers.ssm.out_proj"))
    q = dict(flatten(llama.init_params(dict(LLAMA, norm_eps=1e-5), gen)))
    assert matmul_params(LLAMA) == sum(
        v.numel() for k, v in q.items()
        if k == "embed" or ".attn." in k or ".ffn." in k)


def test_channel_work_by_hand():
    assert K.channel_work(100, 4) == (800, 1700)
    assert K.channel_work(100, 4, wire=True) == (800 + 100 + 16, 1700)
    assert K.channel_bound_s(1000, 2) == pytest.approx(8000 / HBM_BYTES)


def test_ssd_forward_work_by_hand():
    # 4 cells of 2 heads (2 head groups), L 3, P 2, N 5
    nbytes, ops = K.ssd_fwd_work(4, 2, 3, 2, 5)
    assert nbytes == 4 * (4 * 6 + 2 * 2 * 15 + 4 * 3 + 4 * 6 + 4 * 10 + 4)
    assert ops == 2 * 3 * 4 * 5 + 4 * 3 * 4 * 2 + 4 * 2 * 3 * 5 * 2
    assert K.ssd_fwd_bound_s(4, 2, 3, 2, 5) == pytest.approx(
        max(nbytes / HBM_BYTES, 3 * ops / TF32_FLOPS))


def test_ssd_backward_work_by_hand():
    nbytes, ops = K.ssd_bwd_work(4, 2, 3, 2, 5)
    ins = 4 * (2 * 4 * 6 + 4 * 10 + 4 + 4 * 3) + 2 * 4 * 2 * 15
    outs = 4 * (4 * 6 + 4 * 3) + 2 * 4 * 2 * 15
    assert nbytes == ins + outs
    assert ops == 3 * 2 * 3 * 4 * 5 + 4 * (2 * 3 * 4 * 2 + 4 * 3 * 5 * 2)
    assert K.ssd_bwd_bound_s(4, 2, 3, 2, 5, tensor_cores=False) == \
        pytest.approx(max(nbytes / HBM_BYTES, ops / F32_FLOPS))


def test_ssd_call_shape_of_a_round():
    from types import SimpleNamespace
    from perfbench.work.shapes import ssd_call
    spec = SimpleNamespace(
        config={"model": {"ssm_expand": 2, "d_model": 1024,
                          "ssm_head_dim": 64, "ssm_chunk": 256,
                          "ssm_state": 128}},
        traffic={"batch": 8, "local_steps": 1, "seq": 2048})
    # 8 sequences of 8 chunks of 32 heads, folded into one call
    assert ssd_call(spec) == (8 * 8 * 32, 32, 256, 64, 128)
