"""Optimizers on fp32 master weights (port of `sgd`, `lars`, `quant_sgd`
and `make_optimizer` from `cpd_tpu/train/optim.py`).

`sgd` — torch.optim.SGD semantics, optionally Nesterov, weight decay on
the leaves ``wd_mask`` selects:

    d    = g + wd * w
    buf  = momentum * buf + d
    w    = w + (-lr) * (d + momentum * buf  if nesterov else  buf)

`lars` — the reference's hand-written LARS (mix.py:297-310), quirks
kept: the trust ratio on the UN-decayed gradient norm, the fixed 0.001
coefficient, the rate folded into the buffer:

    local_lr = ||w|| / (||g|| + wd * ||w||) * 0.001
    buf      = momentum * buf + (lr * local_lr) * (g + wd * w)
    w        = w + (-buf)

`quant_sgd` — `sgd` with the momentum buffer held in eXmY, every
intermediate of its update cast (``Q``), optionally Kahan-compensated:

    s = Q(momentum * buf)
    naive:  buf' = Q(s + d)
    kahan:  y = Q(d - Q(momentum * c));  buf' = Q(s + y)
            c' = Q(Q(buf' - s) - y)

At (8, 23) the cast is the identity.  ``rounding="stochastic"`` rounds
every cast stochastically: step s keys leaf i with ``split(fold_in(
PRNGKey(seed), s), n_leaves)[i]`` and cast site j (0-1 naive, 0-5 Kahan)
with ``fold_in(leaf_key, j)``, drawing ``jax.random.bits(site_key,
shape)``'s bits.  On CUDA tensors each ``Q(x)`` is one K1 launch (the
flat `sr_bits` + K2 under SR) and each ``Q(a + b)`` one K3 (`sr_bits` +
K4), ``a - b`` sent as ``a + (-b)``, which IEEE makes identical;
``fused=False`` (or CPU tensors) runs their plain versions.

Each line is separate fp32 operations in the JAX function's order (no
fused multiply-add), so given the same gradients `sgd` and `quant_sgd`
are bitwise the JAX ones.  LARS's two norms are fp32 reductions that
XLA and ATen sum in other orders: given the same norms, the rest is
bitwise (``w - buf`` is ``w + (-buf)`` in IEEE).  ``apply`` updates the weights in place and returns the new
optimizer state; every optimizer takes ``fused`` (used by `quant_sgd`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..parallel.reduction import _use_kernel, cast_site
from ..quant.prng import PRNGKey, fold_in, split

__all__ = ["SGD", "TorchSGDState", "sgd", "LARS", "lars", "QuantSGD",
           "QuantSGDState", "quant_sgd", "make_optimizer"]


class TorchSGDState(NamedTuple):
    step: int
    momentum_buf: list


class QuantSGDState(NamedTuple):
    step: int
    momentum_buf: list
    comp: list            # Kahan residuals; [] without Kahan
    key: Optional[tuple]  # the PRNG key under SR, else None


def _mask(wd_mask: Optional[Callable], params: list) -> list:
    """``wd_mask(params)`` -> one bool a leaf (all True by default)."""
    if wd_mask is None:
        return [True] * len(params)
    mask = [bool(m) for m in wd_mask(params)]
    if len(mask) != len(params):
        raise ValueError(f"wd_mask gave {len(mask)} flags for "
                         f"{len(params)} leaves")
    return mask


def _decayed(grads: list, params: list, weight_decay: float,
             mask: list) -> list:
    """``wd * w + g`` on the leaves the mask selects (multi-tensor ops),
    ``g`` elsewhere."""
    out = list(grads)
    idx = [i for i, m in enumerate(mask) if m] if weight_decay else []
    if idx:
        d = torch._foreach_mul([params[i] for i in idx], weight_decay)
        torch._foreach_add_(d, [grads[i] for i in idx])
        for i, t in zip(idx, d):
            out[i] = t
    return out


class SGD:
    """``init(params) -> state``; ``apply(grads, state, params) ->
    state`` updates ``params`` (and the state's buffers) in place."""

    def __init__(self, schedule: Callable, momentum: float = 0.9,
                 weight_decay: float = 0.0, nesterov: bool = False,
                 wd_mask: Optional[Callable] = None):
        self.schedule = schedule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.wd_mask = wd_mask

    def init(self, params: Sequence[torch.Tensor]) -> TorchSGDState:
        return TorchSGDState(0, [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor], state: TorchSGDState,
              params: Sequence[torch.Tensor], *,
              fused: Optional[bool] = None) -> TorchSGDState:
        params, grads = list(params), list(grads)
        bufs = state.momentum_buf
        lr = self.schedule(state.step)
        d = _decayed(grads, params, self.weight_decay,
                     _mask(self.wd_mask, params))
        torch._foreach_mul_(bufs, self.momentum)
        torch._foreach_add_(bufs, d)
        if self.nesterov:
            direction = torch._foreach_mul(bufs, self.momentum)
            torch._foreach_add_(direction, d)
            torch._foreach_add_(params, torch._foreach_mul(direction, -lr))
        else:
            torch._foreach_add_(params, torch._foreach_mul(bufs, -lr))
        return TorchSGDState(state.step + 1, bufs)


def sgd(schedule: Callable, momentum: float = 0.9, weight_decay: float = 0.0,
        nesterov: bool = False, wd_mask: Optional[Callable] = None) -> SGD:
    """torch.optim.SGD-semantics optimizer over a `Schedule`; ``wd_mask(
    params)`` -> one bool a leaf picks the leaves that take weight
    decay."""
    return SGD(schedule, momentum, weight_decay, nesterov, wd_mask)


def _norms(xs: list) -> torch.Tensor:
    """The L2 norm of every leaf of ``xs``, an fp32 (n_leaves,) vector
    (one multi-tensor pass)."""
    return torch.stack(torch._foreach_norm(xs))


class LARS:
    """The reference's LARS (module docstring); the state is
    `TorchSGDState`."""

    def __init__(self, schedule: Callable, momentum: float = 0.9,
                 weight_decay: float = 0.0, coefficient: float = 0.001):
        self.schedule = schedule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.coefficient = coefficient

    def init(self, params: Sequence[torch.Tensor]) -> TorchSGDState:
        return TorchSGDState(0, [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor], state: TorchSGDState,
              params: Sequence[torch.Tensor], *,
              fused: Optional[bool] = None) -> TorchSGDState:
        params, grads = list(params), list(grads)
        bufs = state.momentum_buf
        lr = self.schedule(state.step)
        wd = self.weight_decay
        # every leaf's trust ratio at once: elementwise over the leaves,
        # so each is the one the leaf alone would give
        w_norm, g_norm = _norms(params), _norms(grads)
        local_lr = w_norm / (g_norm + wd * w_norm) * self.coefficient
        rate = (lr * local_lr).unbind()
        d = torch._foreach_mul(params, wd)
        torch._foreach_add_(d, grads)
        torch._foreach_mul_(bufs, self.momentum)
        torch._foreach_add_(bufs, torch._foreach_mul(d, rate))
        torch._foreach_sub_(params, bufs)
        return TorchSGDState(state.step + 1, bufs)


def lars(schedule: Callable, momentum: float = 0.9,
         weight_decay: float = 0.0, coefficient: float = 0.001) -> LARS:
    """The reference's LARS over a `Schedule`."""
    return LARS(schedule, momentum, weight_decay, coefficient)


class QuantSGD:
    """`sgd` with an eXmY momentum buffer (module docstring)."""

    def __init__(self, schedule: Callable, momentum: float = 0.9,
                 weight_decay: float = 0.0, exp: int = 8, man: int = 23,
                 use_kahan: bool = False, nesterov: bool = False,
                 wd_mask: Optional[Callable] = None,
                 rounding: str = "nearest", seed: int = 0):
        if rounding not in ("nearest", "stochastic"):
            raise ValueError(f"unknown rounding mode: {rounding!r}")
        self.schedule = schedule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.fmt = (exp, man)
        self.use_kahan = use_kahan
        self.nesterov = nesterov
        self.wd_mask = wd_mask
        self.identity = (exp, man) == (8, 23)
        self.stochastic = rounding == "stochastic" and not self.identity
        self.seed = seed

    def init(self, params: Sequence[torch.Tensor]) -> QuantSGDState:
        zeros = [torch.zeros_like(p) for p in params]
        comp = [torch.zeros_like(p) for p in params] if self.use_kahan \
            else []
        return QuantSGDState(0, zeros, comp,
                             PRNGKey(self.seed) if self.stochastic else None)

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor], state: QuantSGDState,
              params: Sequence[torch.Tensor], *,
              fused: Optional[bool] = None) -> QuantSGDState:
        params, grads = list(params), list(grads)
        if not params:
            return QuantSGDState(state.step + 1, [], [], state.key)
        lr = self.schedule(state.step)
        m = self.momentum
        kernel = _use_kernel(params[0], fused)
        exp, man = self.fmt
        leaf_keys = ([None] * len(params) if not self.stochastic else
                     split(fold_in(state.key, state.step), len(params)))

        def q(x, y, leaf_key, site):
            """``Q(x [+ y])`` at one cast site of one leaf."""
            if self.identity:
                return x if y is None else x + y
            key = None if leaf_key is None else fold_in(leaf_key, site)
            return cast_site(x, y, exp, man, kernel=kernel, key=key,
                             flat=True)

        d_all = _decayed(grads, params, self.weight_decay,
                         _mask(self.wd_mask, params))
        bufs, comps = [], []
        for i, (d, w, buf) in enumerate(zip(d_all, params,
                                            state.momentum_buf)):
            k = leaf_keys[i]
            if self.use_kahan:
                s = q(m * buf, None, k, 0)
                y = q(d, -q(m * state.comp[i], None, k, 1), k, 2)
                new_buf = q(s, y, k, 3)
                comps.append(q(q(new_buf, -s, k, 4), -y, k, 5))
            else:
                new_buf = q(q(m * buf, None, k, 0), d, k, 1)
            direction = d + m * new_buf if self.nesterov else new_buf
            w.add_(-lr * direction)
            bufs.append(new_buf)
        return QuantSGDState(state.step + 1, bufs, comps, state.key)


def quant_sgd(schedule: Callable, momentum: float = 0.9,
              weight_decay: float = 0.0, exp: int = 8, man: int = 23,
              use_kahan: bool = False, nesterov: bool = False,
              wd_mask: Optional[Callable] = None, rounding: str = "nearest",
              seed: int = 0) -> QuantSGD:
    """torch-SGD semantics with the momentum buffer held in eXmY (module
    docstring)."""
    return QuantSGD(schedule, momentum, weight_decay, exp, man, use_kahan,
                    nesterov, wd_mask, rounding, seed)


def make_optimizer(name: str, schedule: Callable, momentum: float = 0.9,
                   weight_decay: float = 0.0, nesterov: bool = False,
                   wd_mask: Optional[Callable] = None, opt_exp: int = 8,
                   opt_man: int = 23, opt_kahan: bool = False,
                   clip_norm: Optional[float] = None,
                   opt_rounding: str = "nearest", opt_seed: int = 0):
    """The trainers' registry: 'sgd' | 'nesterov' | 'lars' |
    'quant_sgd' (opt_exp/opt_man/opt_kahan/opt_rounding/opt_seed apply
    to 'quant_sgd').  'adamw' and ``clip_norm`` are not ported yet."""
    if name == "adamw":
        raise NotImplementedError("optimizer 'adamw' is not ported to "
                                  "cpd_tpu_torch yet (ROADMAP Queue A, A4)")
    if clip_norm is not None:
        raise NotImplementedError("clip_norm (global-norm clipping) is not "
                                  "ported to cpd_tpu_torch yet (ROADMAP "
                                  "Queue A, A4)")
    if name == "sgd":
        return sgd(schedule, momentum, weight_decay, nesterov=nesterov,
                   wd_mask=wd_mask)
    if name == "nesterov":
        return sgd(schedule, momentum, weight_decay, nesterov=True,
                   wd_mask=wd_mask)
    if name == "lars":
        return lars(schedule, momentum, weight_decay)
    if name == "quant_sgd":
        return quant_sgd(schedule, momentum, weight_decay, exp=opt_exp,
                         man=opt_man, use_kahan=opt_kahan,
                         nesterov=nesterov, wd_mask=wd_mask,
                         rounding=opt_rounding, seed=opt_seed)
    raise ValueError(f"unknown optimizer {name!r}")
