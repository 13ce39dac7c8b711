"""The shapes at which a cell calls a kernel, from its files alone."""
from typing import Tuple


def ssd_call(spec) -> Tuple[int, int, int, int, int]:
    """(cells, heads, L, P, N) of one call of kernel C (forward or
    backward) in a fed round: each local step runs every group's
    microbatch at once, the groups folded into the cells, so a call holds
    batch / local_steps sequences of seq / L chunks of H heads."""
    m, t = spec.config["model"], spec.traffic
    di = m["ssm_expand"] * m["d_model"]
    P = m["ssm_head_dim"]
    H = di // P
    L = min(m["ssm_chunk"], t["seq"])
    cells = t["batch"] // t["local_steps"] * (t["seq"] // L) * H
    return cells, H, L, P, m["ssm_state"]
