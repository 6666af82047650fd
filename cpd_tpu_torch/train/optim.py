"""Optimizers on fp32 master weights (port of `sgd`, `lars`, `quant_sgd`,
``adamw``, ``clip_norm`` and `make_optimizer` from
`cpd_tpu/train/optim.py`).

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
bitwise (``w - buf`` is ``w + (-buf)`` in IEEE).

`adamw` — ``optax.adamw(schedule, b1=momentum, weight_decay=wd,
mask=wd_mask)`` at optax 0.2.6's defaults (`ADAM_B2` 0.999, `ADAM_EPS`
1e-8, eps_root 0), in optax's order (the decay is added to the Adam
direction, not to the weights before the step as ``torch.optim.AdamW``
does):

    mu = (1 - b1) * g + b1 * mu;   nu = (1 - b2) * (g * g) + b2 * nu
    count += 1
    u  = (mu / (1 - b1**count)) / (sqrt(nu / (1 - b2**count)) + eps)
    w  = w + (-lr(count - 1)) * (u + wd * w   where the mask is true)

The bias corrections ``1 - b**count`` are fp32 host scalars (numpy's
fp32 power, which may differ from XLA's ``pow`` in the last bit); given
the same corrections the rest is bitwise optax's, op by op.

`clip_norm` (`ClipByGlobalNorm`) puts ``optax.clip_by_global_norm`` in
front of any optimizer: ``g_norm`` = sqrt of the sum over the leaves of
each leaf's sum of squares (each leaf's norm from one multi-tensor
``_foreach_norm``, squared); below ``max_norm`` the gradients pass
unchanged, otherwise each ``g`` becomes ``(g / g_norm) * max_norm``.
The choice is made on the card (a divide and a multiply by 1 below the
norm, both exact), with no host sync.

``apply`` updates the weights in place and returns the new optimizer
state; every optimizer takes ``fused`` (used by `quant_sgd`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..parallel.reduction import _use_kernel, cast_site
from ..quant.prng import PRNGKey, fold_in, split

__all__ = ["SGD", "TorchSGDState", "sgd", "LARS", "lars", "QuantSGD",
           "QuantSGDState", "quant_sgd", "AdamW", "AdamState", "adamw",
           "ClipByGlobalNorm", "clip_by_global_norm", "global_norm",
           "make_optimizer"]


class TorchSGDState(NamedTuple):
    step: int
    momentum_buf: list


class AdamState(NamedTuple):
    count: int
    mu: list
    nu: list


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
    (one multi-tensor pass): the squares summed in float64 and the norm
    rounded to fp32 once, so it is the correctly rounded norm but for a
    tie, whatever order the sum takes.  A norm assembled from partial
    sums (ZeRO's shards, `parallel.zero`) then rounds to the same fp32
    value; an fp32 sum of a 2.4 M-element leaf misses by ~1e-5."""
    return torch.stack(torch._foreach_norm(
        xs, 2, dtype=torch.float64)).to(torch.float32)


class LARS:
    """The reference's LARS (module docstring); the state is
    `TorchSGDState`.  Its trust ratios need global norms
    (``norm_based``: a shard-local step refuses it, `train.state.
    reject_norm_based`)."""

    norm_based = True

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


def bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in fp32, as a Python float."""
    f32 = np.float32
    return float(f32(1) - f32(decay) ** f32(count))


# optax.adamw's defaults, which the reference's make_optimizer keeps
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


class AdamW:
    """optax's ``adamw`` (module docstring)."""

    def __init__(self, schedule: Callable, b1: float = 0.9,
                 weight_decay: float = 1e-4,
                 wd_mask: Optional[Callable] = None):
        self.schedule = schedule
        self.b1 = b1
        self.weight_decay = weight_decay
        self.wd_mask = wd_mask

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor], state: AdamState,
              params: Sequence[torch.Tensor], *,
              fused: Optional[bool] = None) -> AdamState:
        params, grads = list(params), list(grads)
        b1, b2 = self.b1, ADAM_B2
        # the moments, each product rounded before the sum (no FMA)
        mu = list(torch._foreach_mul(grads, 1 - b1))
        torch._foreach_add_(mu, torch._foreach_mul(state.mu, b1))
        nu = list(torch._foreach_mul(grads, grads))
        torch._foreach_mul_(nu, 1 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(state.nu, b2))
        count = state.count + 1
        denom = torch._foreach_div(nu, bias_correction(b2, count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        u = torch._foreach_div(mu, bias_correction(b1, count))
        torch._foreach_div_(u, denom)
        # the decoupled decay u + wd * w (u is never -0.0, so skipping it
        # at wd = 0 changes no bit)
        u = _decayed(u, params, self.weight_decay,
                     _mask(self.wd_mask, params))
        torch._foreach_mul_(u, -self.schedule(state.count))
        torch._foreach_add_(params, u)
        return AdamState(count, mu, nu)


def adamw(schedule: Callable, b1: float = 0.9, weight_decay: float = 1e-4,
          wd_mask: Optional[Callable] = None) -> AdamW:
    """optax's ``adamw`` over a `Schedule`; ``wd_mask(params)`` -> one
    bool a leaf picks the leaves that take the decoupled decay."""
    return AdamW(schedule, b1, weight_decay, wd_mask)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's sum of squares, a
    0-d fp32 tensor (one multi-tensor pass over the leaves)."""
    norms = torch.stack(torch._foreach_norm(list(grads)))
    return (norms * norms).sum().sqrt()


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> list:
    """``optax.clip_by_global_norm``'s update: ``grads`` unchanged below
    ``max_norm``, else each ``(g / g_norm) * max_norm``."""
    grads = list(grads)
    if not grads:
        return grads
    g_norm = global_norm(grads)
    below = g_norm < max_norm
    one = torch.ones_like(g_norm)
    # below the norm: g / 1 * 1, which is g bit for bit
    out = torch._foreach_div(grads, torch.where(below, one, g_norm))
    torch._foreach_mul_(out, torch.where(below, one, one * max_norm))
    return list(out)


class ClipByGlobalNorm:
    """``inner`` fed globally clipped gradients; its state is the inner
    optimizer's (the clip keeps none).  The global norm makes it
    ``norm_based``."""

    norm_based = True

    def __init__(self, inner, max_norm: float):
        if max_norm <= 0:
            raise ValueError(f"clip_norm must be > 0, got {max_norm}")
        self.inner = inner
        self.max_norm = max_norm

    def init(self, params: Sequence[torch.Tensor]):
        return self.inner.init(params)

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor], state,
              params: Sequence[torch.Tensor], *,
              fused: Optional[bool] = None):
        return self.inner.apply(clip_by_global_norm(grads, self.max_norm),
                                state, params, fused=fused)


def make_optimizer(name: str, schedule: Callable, momentum: float = 0.9,
                   weight_decay: float = 0.0, nesterov: bool = False,
                   wd_mask: Optional[Callable] = None, opt_exp: int = 8,
                   opt_man: int = 23, opt_kahan: bool = False,
                   clip_norm: Optional[float] = None,
                   opt_rounding: str = "nearest", opt_seed: int = 0):
    """The trainers' registry: 'sgd' | 'nesterov' | 'lars' |
    'quant_sgd' | 'adamw' (opt_exp/opt_man/opt_kahan/opt_rounding/
    opt_seed apply to 'quant_sgd'; 'adamw' takes ``momentum`` as b1 and
    ``wd_mask`` for its decoupled decay).  ``clip_norm`` puts global-norm
    gradient clipping in front (`ClipByGlobalNorm`)."""
    if name == "adamw":
        tx = adamw(schedule, b1=momentum, weight_decay=weight_decay,
                   wd_mask=wd_mask)
    elif name == "sgd":
        tx = sgd(schedule, momentum, weight_decay, nesterov=nesterov,
                 wd_mask=wd_mask)
    elif name == "nesterov":
        tx = sgd(schedule, momentum, weight_decay, nesterov=True,
                 wd_mask=wd_mask)
    elif name == "lars":
        tx = lars(schedule, momentum, weight_decay)
    elif name == "quant_sgd":
        tx = quant_sgd(schedule, momentum, weight_decay, exp=opt_exp,
                       man=opt_man, use_kahan=opt_kahan,
                       nesterov=nesterov, wd_mask=wd_mask,
                       rounding=opt_rounding, seed=opt_seed)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    if clip_norm is not None:
        return ClipByGlobalNorm(tx, clip_norm)
    return tx
