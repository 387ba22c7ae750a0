"""Attention-map transforms (counterpart of ``attwarp_tpu/warp/transforms.py``).

``Transform`` and ``WarpParams`` are plain Python, copied rather than
imported: importing anything under ``attwarp_tpu.warp`` pulls in JAX. The
tests pin the copies equal to the originals.

Semantics (reference ``new_method.py``):
- identity:  x
- square:    x**2               (inverse: sqrt(max(x, 0)))
- sqrt:      sqrt(max(x, 0))    (inverse: x**2)
- exp:       exp(scale*x)/div   (inverse: log(max(x*div, 1e-9))/scale)
- log:       log(x + 1e-5)      (inverse: exp(x) - 1e-5)
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class Transform(str, enum.Enum):
    IDENTITY = "identity"
    SQUARE = "square"
    SQRT = "sqrt"
    EXP = "exp"
    LOG = "log"

    @classmethod
    def from_name(cls, name: str) -> "Transform":
        """Resolve a transform by name; unknown names fall back to identity
        (matching ``set_transform_function``, new_method.py:398-401)."""
        try:
            return cls(str(name).lower())
        except ValueError:
            return cls.IDENTITY


@dataclasses.dataclass(frozen=True)
class WarpParams:
    """Configuration for one warp invocation (frozen, hashable)."""

    transform: Transform = Transform.IDENTITY
    exp_scale: float = 1.0
    exp_divisor: float = 1.0
    # "apply transform, take marginal, apply inverse" workflow
    # (new_method.py:162-163,219-226)
    apply_inverse_to_marginals: bool = False


def apply_transform(x: torch.Tensor, params: WarpParams) -> torch.Tensor:
    t = params.transform
    if t is Transform.IDENTITY:
        return x
    if t is Transform.SQUARE:
        return x * x
    if t is Transform.SQRT:
        return torch.sqrt(torch.clamp(x, min=0.0))
    if t is Transform.EXP:
        return torch.exp(params.exp_scale * x) / params.exp_divisor
    if t is Transform.LOG:
        return torch.log(x + 1e-5)
    raise ValueError(f"unknown transform {t!r}")


def apply_inverse_transform(x: torch.Tensor, params: WarpParams) -> torch.Tensor:
    t = params.transform
    if t is Transform.IDENTITY:
        return x
    if t is Transform.SQUARE:
        return torch.sqrt(torch.clamp(x, min=0.0))
    if t is Transform.SQRT:
        return x * x
    if t is Transform.EXP:
        return torch.log(torch.clamp(x * params.exp_divisor, min=1e-9)) / params.exp_scale
    if t is Transform.LOG:
        return torch.exp(x) - 1e-5
    raise ValueError(f"unknown transform {t!r}")
