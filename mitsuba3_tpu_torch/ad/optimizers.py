"""Optimizers — counterpart of ``mitsuba3_tpu/ad/optimizers.py``: the JAX
package's dict-style wrapper with optax's update rules, written out for
tensors (not ``torch.optim``'s, whose RMSProp differs):

    opt = mi.ad.Adam(lr=0.05, params={"albedo": albedo})
    for it in range(n):
        grads = {"albedo": ...}          # d loss / d opt["albedo"]
        opt.step(grads)

A rule is a pair of functions, ``init(params) -> state`` and
``update(grads, state) -> (updates, state)``, over flat dicts of tensors,
as optax's ``GradientTransformation`` is over pytrees. Updates run without
autograd; the parameters stay on their tensors' device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Rule(NamedTuple):
    init: Callable
    update: Callable


class Optimizer:
    def __init__(self, tx: Rule, params: dict):
        self.tx = tx
        self.params = {k: torch.as_tensor(v).detach()
                       for k, v in params.items()}
        self.state = tx.init(self.params)

    def step(self, grads: dict):
        with torch.no_grad():
            updates, self.state = self.tx.update(
                {k: grads[k] for k in self.params}, self.state)
            self.params = {k: (p + updates[k]).to(p.dtype)
                           for k, p in self.params.items()}
        return self.params

    def __getitem__(self, k):
        return self.params[k]

    def __setitem__(self, k, v):
        # writing a parameter re-initialises the state of every parameter,
        # as the JAX package's tx.init(self.params) does
        self.params[k] = torch.as_tensor(v).detach()
        self.state = self.tx.init(self.params)

    def items(self):
        return self.params.items()


def _zeros(params):
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in float32, the power by the host's powf on float32
    operands, as jitted JAX computes optax.tree.bias_correction. Near
    1 - decay the subtraction cancels most digits, so another rounding of
    the power would move Adam's step by ~1e-5 of itself."""
    power = torch.pow(torch.tensor(decay, dtype=torch.float32),
                      torch.tensor(float(count), dtype=torch.float32))
    return float(1.0 - power)


def adam(lr, b1=0.9, b2=0.999, eps=1e-8) -> Rule:
    """optax.adam: bias-corrected moments, eps outside the square root."""
    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(grads, state):
        count = state["count"] + 1
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * g ** 2 + b2 * state["nu"][k]
              for k, g in grads.items()}
        out = {}
        for k, m in mu.items():
            m_hat = m / _bias_correction(b1, count)
            n_hat = nu[k] / _bias_correction(b2, count)
            out[k] = m_hat / (torch.sqrt(n_hat) + eps) * (-lr)
        return out, {"count": count, "mu": mu, "nu": nu}

    return Rule(init, update)


def sgd(lr, momentum=0.0) -> Rule:
    """optax.sgd with a momentum trace (trace = g + momentum * trace)."""
    def init(params):
        return {"trace": _zeros(params)}

    def update(grads, state):
        trace = {k: g + momentum * state["trace"][k]
                 for k, g in grads.items()}
        return {k: t * (-lr) for k, t in trace.items()}, {"trace": trace}

    return Rule(init, update)


def rmsprop(lr, decay=0.9, eps=1e-8) -> Rule:
    """optax.rmsprop: no bias correction and eps inside the square root,
    g * rsqrt(nu + eps) (torch.optim.RMSprop puts eps outside and decays
    by 0.99)."""
    def init(params):
        return {"nu": _zeros(params)}

    def update(grads, state):
        nu = {k: (1 - decay) * g ** 2 + decay * state["nu"][k]
              for k, g in grads.items()}
        return ({k: torch.rsqrt(nu[k] + eps) * g * (-lr)
                 for k, g in grads.items()}, {"nu": nu})

    return Rule(init, update)


def Adam(lr=0.01, beta_1=0.9, beta_2=0.999, params=None):
    return Optimizer(adam(lr, b1=beta_1, b2=beta_2), params or {})


def SGD(lr=0.01, momentum=0.0, params=None):
    return Optimizer(sgd(lr, momentum=momentum), params or {})


def RMSProp(lr=0.01, params=None):
    return Optimizer(rmsprop(lr), params or {})
