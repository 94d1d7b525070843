"""A generic associative scan in plain PyTorch
(vi_diffusion_processes_tpu/ops/blocked_scan.py, ``lax.associative_scan``).

The JAX package computes its filters, smoothers and d ≥ 2 marginals with
XLA associative scans, outside any hand-written kernel; its blocked window
layout answers TPU relayouts and has no counterpart here.  This is the
odd–even recursion of ``lax.associative_scan`` with the same association
order, so float64 results agree with it to the last digits: ``log₂ N``
levels down, ``log₂ N`` up, two calls of ``fn`` per level on strided views.
Autograd differentiates it.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

__all__ = ["assoc_scan"]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``even[0], odd[0], even[1], …`` along axis 0; ``even`` has as many
    rows as ``odd`` or one more."""
    m = odd.shape[0]
    out = torch.stack((even[:m], odd), dim=1).flatten(0, 1)
    if even.shape[0] > m:
        out = torch.cat((out, even[m:]), dim=0)
    return out


def assoc_scan(
    fn: Callable, elems: Sequence[torch.Tensor], *, reverse: bool = False
) -> Tuple[torch.Tensor, ...]:
    """All prefixes of an associative ``fn`` over the leading axis of a
    tuple of tensors: ``out[k] = fn(… fn(fn(e[0], e[1]), e[2]) …, e[k])``.

    ``fn(a, b)`` takes and returns tuples shaped like ``elems`` with any
    leading length, and combines them row by row.  With ``reverse=True`` the
    scan runs from the last row, ``out[k] = fn(… fn(e[N−1], e[N−2]) …,
    e[k])``: the first argument of ``fn`` is the combined later suffix, the
    second the earlier element, which is ``lax.associative_scan``'s operand
    convention."""
    elems = tuple(elems)
    n = elems[0].shape[0]
    if any(e.shape[0] != n for e in elems):
        raise ValueError("assoc_scan: the leading axes differ")
    if reverse:
        elems = tuple(torch.flip(e, (0,)) for e in elems)

    def scan(xs):
        k = xs[0].shape[0]
        if k < 2:
            return xs
        reduced = fn(tuple(x[0:-1:2] for x in xs), tuple(x[1::2] for x in xs))
        odd = scan(tuple(reduced))
        later = tuple(x[2::2] for x in xs)
        if k == 2:
            return tuple(_interleave(x[:1], o) for x, o in zip(xs, odd))
        if k % 2 == 0:
            even = fn(tuple(o[:-1] for o in odd), later)
        else:
            even = fn(odd, later)
        even = tuple(torch.cat((x[:1], e), dim=0) for x, e in zip(xs, even))
        return tuple(_interleave(e, o) for e, o in zip(even, odd))

    out = scan(elems)
    if reverse:
        out = tuple(torch.flip(o, (0,)) for o in out)
    return out
