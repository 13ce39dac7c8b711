"""The paper's Fashion-MNIST CNN (TEASQ-Fed §5.1), in PyTorch.

"two 2x2 convolutional layers, a fully connected layer, and a softmax
output": conv(2x2,32) + pool, conv(2x2,32) + pool, fc(128), fc(10), about
206k float32 parameters.

The public layouts are the JAX package's, so that weights carry across
unchanged: images are NHWC, conv weights HWIO, and ``fc1`` reads the
pooled features flattened in (H, W, C) order.  Inside, the convolutions run
in PyTorch's NCHW/OIHW.  XLA's ``SAME`` padding for an even 2x2 kernel pads
0 before and 1 after each spatial axis; the 2x2 pools see even sizes (28,
14) and need no padding.

Three forms of the same model: the functional ``cnn_forward(params,
images)`` over a parameter dict, which the FL layer trains; the
:class:`CNN` module, which holds the same dict as ``nn.Parameter``s; and
the cohort form (``cnn_cohort_*``), in which every leaf carries a leading
device axis C and a cohort of devices trains in one pass.  As in the JAX
package, the cohort form writes each 2x2 convolution as 2x2 patches times
the flattened HWIO weight (one batched matmul a layer), and its loss is
the mean over all (C, B) examples.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.utils.tree import resolve_device

Params = Dict[str, torch.Tensor]


def init_cnn(generator: torch.Generator, n_classes: int = 10,
             channels: int = 32, fc_width: int = 128,
             device=None) -> Params:
    """Uniform fan-in init with the JAX package's bounds and shapes, drawn
    from ``generator`` (a ``torch.Generator`` on the CPU; the result moves
    to ``device``, the card unless the caller names one:
    ``utils.tree.resolve_device``).  The draws differ from ``jax.random``'s; a test that
    needs JAX's own weights carries them over with
    ``repro_torch.utils.tree.from_numpy``."""

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (u * 2.0 - 1.0) * bound

    flat = 7 * 7 * channels
    params = {
        "conv1": uniform((2, 2, 1, channels), 1.0 / math.sqrt(4 * 1)),
        "b1": torch.zeros(channels),
        "conv2": uniform((2, 2, channels, channels),
                         1.0 / math.sqrt(4 * channels)),
        "b2": torch.zeros(channels),
        "fc1": uniform((flat, fc_width), 1.0 / math.sqrt(flat)),
        "bf1": torch.zeros(fc_width),
        "fc2": uniform((fc_width, n_classes), 1.0 / math.sqrt(fc_width)),
        "bf2": torch.zeros(n_classes),
    }
    device = resolve_device(device)
    return {k: v.to(device) for k, v in params.items()}


def _conv(x: torch.Tensor, w_hwio: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """NCHW input, HWIO weight, XLA ``SAME`` padding (low 0, high 1)."""
    x = F.pad(x, (0, 1, 0, 1))
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), b)


def cnn_features(params: Params, images: torch.Tensor) -> torch.Tensor:
    """Penultimate representation, (B, fc_width), from NHWC images."""
    x = images.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(_conv(x, params["conv1"], params["b1"])), 2)
    x = F.max_pool2d(F.relu(_conv(x, params["conv2"], params["b2"])), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)     # (H, W, C) order
    return F.relu(x @ params["fc1"] + params["bf1"])


def cnn_forward(params: Params, images: torch.Tensor) -> torch.Tensor:
    """images: (B, 28, 28, 1) -> logits (B, 10)."""
    return cnn_features(params, images) @ params["fc2"] + params["bf2"]


def cnn_loss(params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean cross-entropy of the batch ``{"images", "labels"}``."""
    logits = cnn_forward(params, batch["images"])
    return F.cross_entropy(logits, batch["labels"].long())


def cnn_accuracy(params: Params, images: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    hits = (cnn_forward(params, images).argmax(-1) == labels).sum()
    return hits.to(torch.float32) / labels.numel()


# ----------------------------------------------------------------------
# Cohort form: per-device weights with a leading axis C
# ----------------------------------------------------------------------
def _patches2x2(x: torch.Tensor) -> torch.Tensor:
    """(C, B, H, W, F) -> (C, B, H, W, 4F): the 2x2 patches under XLA's
    SAME padding for an even kernel (pad low 0, high 1), in HWIO's (h, w)
    order."""
    xp = F.pad(x, (0, 0, 0, 1, 0, 1))
    return torch.cat([xp[:, :, :-1, :-1], xp[:, :, :-1, 1:],
                      xp[:, :, 1:, :-1], xp[:, :, 1:, 1:]], dim=-1)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    c, b, h, w, f = x.shape
    return x.reshape(c, b, h // 2, 2, w // 2, 2, f).amax(dim=(3, 5))


def _conv2x2_cohort(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """x: (C, B, H, W, Fin); w: (C, 2, 2, Fin, Fout) -> (C, B, H, W, Fout)."""
    c, nb, h, wd, _ = x.shape
    p = _patches2x2(x).reshape(c, nb * h * wd, -1)
    wk = w.reshape(c, 4 * w.shape[3], w.shape[4])
    return (torch.bmm(p, wk).reshape(c, nb, h, wd, -1)
            + b[:, None, None, None, :])


def cnn_cohort_features(params: Params, images: torch.Tensor) -> torch.Tensor:
    """Per-device features: leaves carry a leading cohort axis C; images
    are (C, B, 28, 28, 1) -> (C, B, fc_width)."""
    x = _pool2(F.relu(_conv2x2_cohort(images, params["conv1"],
                                      params["b1"])))
    x = _pool2(F.relu(_conv2x2_cohort(x, params["conv2"], params["b2"])))
    x = x.reshape(x.shape[0], x.shape[1], -1)            # (H, W, C) order
    return F.relu(torch.bmm(x, params["fc1"]) + params["bf1"][:, None, :])


def cnn_cohort_forward(params: Params, images: torch.Tensor) -> torch.Tensor:
    """(C, B, 28, 28, 1) -> logits (C, B, 10) with per-device weights."""
    h = cnn_cohort_features(params, images)
    return torch.bmm(h, params["fc2"]) + params["bf2"][:, None, :]


def cnn_cohort_loss(params: Params, images: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over all (C, B) examples of the cohort, so each
    device's gradient is 1/C of its own mean-loss gradient (as in the JAX
    package)."""
    logp = F.log_softmax(cnn_cohort_forward(params, images), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None]).mean()


class CNN(nn.Module):
    """The same model as an ``nn.Module``: its parameters carry the dict's
    names and JAX layouts, and ``forward`` is :func:`cnn_forward`."""

    def __init__(self, params: Params):
        super().__init__()
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value.clone()))

    def params(self) -> Params:
        return dict(self.named_parameters())

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return cnn_forward(self.params(), images)
