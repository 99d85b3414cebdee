"""A hand-written kernel's forward with its plain version's gradient.

The CUDA kernels compute forward passes only. Where autograd needs the
inputs of one, :class:`PlainGradient` runs the kernel forward and, in the
backward, recomputes the plain torch version on detached copies of the
inputs that need a gradient and differentiates that. :func:`dispatch`
chooses between the plain version and the kernel.
"""

from __future__ import annotations

import torch


def swap(x, table: dict):
    """``x`` (a tensor, a NamedTuple of tensors or anything else) with each
    tensor whose id is in ``table`` replaced by its value there."""
    if isinstance(x, torch.Tensor):
        return table.get(id(x), x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[swap(v, table) for v in x])
    return x


def grad_leaves(args) -> list:
    """The tensors in ``args`` (tensors and NamedTuples of them) that
    autograd needs, each once."""
    found = {}
    for x in args:
        for t in (x if isinstance(x, tuple) else (x,)):
            if isinstance(t, torch.Tensor) and t.requires_grad:
                found[id(t)] = t
    return list(found.values())


class PlainGradient(torch.autograd.Function):
    """``apply(kernel, plain, args, *needs)``: ``kernel()``'s output (a
    tensor or a tuple of tensors), with the gradient of ``plain(*args)``
    for ``needs``, the tensors :func:`grad_leaves` finds in ``args``."""

    @staticmethod
    def forward(ctx, kernel, plain, args, *needs):
        ctx.plain, ctx.args = plain, args
        ctx.save_for_backward(*needs)
        return kernel()

    @staticmethod
    def backward(ctx, *grads):
        detached = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        # grad_leaves gives the args' own tensors in the order of `needs`
        table = {id(t): d for t, d in zip(grad_leaves(ctx.args), detached)}
        with torch.enable_grad():
            out = ctx.plain(*[swap(x, table) for x in ctx.args])
        outs = out if isinstance(out, tuple) else (out,)
        got = torch.autograd.grad(outs, detached, grads, allow_unused=True)
        return (None, None, None, *got)


def dispatch(device: torch.device, kernel, plain, args):
    """``plain(*args)`` off the card; on a CUDA ``device``, ``kernel()``
    under ``no_grad``, with the gradient of ``plain`` where autograd needs
    the tensors of ``args``."""
    if device.type != "cuda":
        return plain(*args)

    def forward():
        with torch.no_grad():
            return kernel()

    needs = grad_leaves(args) if torch.is_grad_enabled() else []
    return PlainGradient.apply(forward, plain, args, *needs) if needs else forward()
