"""Forward-mode tangents at the kernel wrappers.

A CUDA kernel writes its outputs through raw pointers, so a
``torch.autograd.forward_ad`` dual passed to it would come back as an output
without a tangent and without an error. Every wrapper therefore either has a
forward rule (a ``torch.autograd.Function`` with a ``jvp``: the collision
fetch's tables, the slant depth's extinction) or refuses an operand that carries a tangent with :func:`refuse_tangents`.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

__all__ = ["tangent", "refuse_tangents"]


def tangent(x):
    """The forward-mode tangent of ``x`` at the current dual level, or None
    (also for a non-tensor and outside any dual level)."""
    if not isinstance(x, torch.Tensor) or getattr(fwAD, "_current_level", 0) < 0:
        return None
    return fwAD.unpack_dual(x).tangent


def refuse_tangents(name, **operands):
    """Raise ``NotImplementedError`` if any of ``operands`` carries a
    forward-mode tangent: ``name`` has no rule for it (its operands are
    geometry, which the sensitivity renders keep detached)."""
    if getattr(fwAD, "_current_level", 0) < 0:
        return
    for arg, x in operands.items():
        if tangent(x) is not None:
            raise NotImplementedError(
                f"{name} has no forward-mode rule for a tangent on {arg!r}: its kernel "
                "writes through raw pointers and would drop it; detach the operand "
                "(the sensitivity renders detach the sampling geometry)"
            )
