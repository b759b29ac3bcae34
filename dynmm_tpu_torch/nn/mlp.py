"""MLP-family encoders and heads of the modality-level models (port of
``dynmm_tpu/nn/mlp.py``; MultiBench's ``MLP``, ``MaxOut_MLP``, ``Linear``
and ``Identity`` contracts).

Submodules carry the flax module names (``fc1``, ``fc2``, ``lin``, ``bn0``,
``max1``, ...), so ``utils/weights.py`` carries the JAX package's variables
across by walking the tree. Unlike flax, a torch module is built with its
input width, so each constructor takes it.

Dropout draws its mask from an explicit ``torch.Generator`` that the caller
hands to every ``Dropout`` of a model (``set_dropout_generator``); in
training, a nonzero rate without one raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Dropout(nn.Module):
    """Inverted dropout (flax ``nn.Dropout``: keep with 1 − rate, scale the
    kept values by 1/(1 − rate)), a no-op in eval or at rate 0. The mask is
    shared along ``broadcast_dims`` (flax's ``broadcast_dims``)."""

    def __init__(self, rate: float, broadcast_dims: tuple = ()):
        super().__init__()
        self.rate, self.broadcast_dims = rate, tuple(broadcast_dims)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("dropout in training needs a torch.Generator "
                               "(nn.mlp.set_dropout_generator)")
        shape = [1 if d in self.broadcast_dims else n
                 for d, n in enumerate(x.shape)]
        keep = torch.rand(shape, generator=self.generator,
                          device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Hand ``generator`` to every ``Dropout`` of ``model``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class BatchNorm1d(nn.Module):
    """BatchNorm over the feature axis with torch semantics (the JAX
    package's ``TorchBatchNorm``: unbiased running variance, flax momentum
    0.9 = torch 0.1, eps 1e-5), without ``num_batches_tracked`` (the flax
    trees carry none). ``affine=False`` is the scale- and bias-free form."""

    def __init__(self, features: int, affine: bool = True, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, self.training,
                            self.momentum, self.eps)


class MLP(nn.Module):
    """``fc1(in, hid) → ReLU → [dropout] → fc2(hid, out)`` (MultiBench
    ``MLP(indim, hiddim, outdim)``)."""

    flax_tree = True  # submodules named after the flax tree

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dropout: bool = False, dropout_rate: float = 0.1):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)
        self.drop = Dropout(dropout_rate) if dropout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.fc1(x))
        if self.drop is not None:
            x = self.drop(x)
        return self.fc2(x)


class Maxout(nn.Module):
    """``max_k (x W_k + b_k)``: one ``lin(in, out·k)`` viewed as
    (…, out, k), the piece index fastest (the flax layout), then a max over
    the pieces."""

    def __init__(self, in_dim: int, out_dim: int, num_pieces: int = 2):
        super().__init__()
        self.out_dim, self.num_pieces = out_dim, num_pieces
        self.lin = nn.Linear(in_dim, out_dim * num_pieces)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.lin(x)
        return y.view(*y.shape[:-1], self.out_dim, self.num_pieces).amax(-1)


class MaxOut_MLP(nn.Module):  # noqa: N801  (MultiBench's name)
    """``bn0(in) → max1(in, h1) → bn1 (affine-free) → dropout → max2(h1, h2)
    → bn2 (affine-free) → dropout [→ out(h2, num_outputs)]``, with
    MultiBench's signature ``MaxOut_MLP(num_outputs, first_hidden,
    number_input_feats, second_hidden, linear_layer)``."""

    flax_tree = True  # submodules named after the flax tree

    def __init__(self, num_outputs: int, first_hidden: int = 64,
                 number_input_feats: int = 300,
                 second_hidden: Optional[int] = None,
                 linear_layer: bool = True, dropout_rate: float = 0.3):
        super().__init__()
        second = first_hidden if second_hidden is None else second_hidden
        self.bn0 = BatchNorm1d(number_input_feats)
        self.max1 = Maxout(number_input_feats, first_hidden)
        self.bn1 = BatchNorm1d(first_hidden, affine=False)
        self.drop1 = Dropout(dropout_rate)
        self.max2 = Maxout(first_hidden, second)
        self.bn2 = BatchNorm1d(second, affine=False)
        self.drop2 = Dropout(dropout_rate)
        self.out = nn.Linear(second, num_outputs) if linear_layer else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop1(self.bn1(self.max1(self.bn0(x))))
        x = self.drop2(self.bn2(self.max2(x)))
        return x if self.out is None else self.out(x)


class LinearHead(nn.Module):
    """Plain linear head ``fc(in, out)`` (MultiBench ``Linear``)."""

    flax_tree = True  # submodules named after the flax tree

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.fc = nn.Linear(in_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


class Identity(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x
