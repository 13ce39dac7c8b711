"""The whole round's share of the card's f32 peak: the model FLOPs of the
window's rounds (``work/model_flops.py``: 6 x the parameters in products
x tokens, attention's causal half once, the SSD's products; no
recompute) over the window's seconds, over 67 TFLOP/s, the f32 rate
outside the tensor cores at which the configurations compute."""
from perfbench.work.model_flops import train_flops_per_token
from perfbench.work.peaks import F32_FLOPS


def read(res, spec):
    if spec.device != "cuda" or not res.rounds:
        return None
    flops = train_flops_per_token(spec.config["model"], spec.traffic["seq"]) \
        * res.tokens_per_round * res.rounds
    return 100.0 * flops / res.window_s / F32_FLOPS
