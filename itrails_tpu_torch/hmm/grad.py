"""Exact gradients of the forward log-likelihood.

The JAX package differentiates a checkpointed scan of the forward pass
(``itrails_tpu/hmm/grad.py:forward_loglik_remat``) and, on the TPU, calls
its fused gradient kernels instead; a long block it differentiates through
``itrails_tpu/hmm/longseq.py:forward_loglik_long_remat``.  Here the
decode's value and gradient with respect to ``(a, bfull, pi)`` come from
kernel K2 (``hmm/cuda_grad.py``) for a (W, T) window batch, and from the
sequence-parallel route ``hmm/longseq.py:forward_loglik_long_and_grads``
(K5's transfer operators, then one K2 call over the block's chunks) for a
long block, on the card, and from their plain versions on the CPU.
:class:`LoglikFn` hands them to torch autograd, which carries them back
through the f64 model build to the demographic parameters.
"""

from __future__ import annotations

import torch

from itrails_tpu_torch.hmm import cuda_grad, longseq

__all__ = ["LoglikFn"]


class LoglikFn(torch.autograd.Function):
    """Total log-likelihood (f64) of token batches as a function of the
    decode tables ``(a, bfull, pi)``, differentiable in those tables.

    Each of ``batches`` is a (W, T) window batch, which one K2 call takes,
    or a 1-D long block, which the long-block route takes.  The forward
    sums every batch's value in f64 and its gradients (each route computes
    both at once) and keeps the summed gradients; the backward scales them
    by the incoming gradient.  Only first derivatives exist."""

    @staticmethod
    def forward(ctx, a, bfull, pi, *batches):
        total = torch.zeros((), dtype=torch.float64, device=a.device)
        grads = [torch.zeros_like(x, dtype=torch.float64) for x in (a, bfull, pi)]
        for tokens in batches:
            route = (longseq.forward_loglik_long_and_grads if tokens.dim() == 1
                     else cuda_grad.loglik_and_grads_fused)
            value, parts = route(a, bfull, pi, tokens)
            total = total + value
            for acc, g in zip(grads, parts):
                acc += g
        ctx.save_for_backward(*grads)
        ctx.dtypes = (a.dtype, bfull.dtype, pi.dtype)
        return total

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_total):
        grads = (grad_total * g for g in ctx.saved_tensors)
        return (*(g.to(dt) for g, dt in zip(grads, ctx.dtypes)),
                *([None] * (len(ctx.needs_input_grad) - 3)))
