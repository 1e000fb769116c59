"""Optimizers and learning-rate schedules, resolved by Keras class name
(counterpart of `ignnition_tpu/training/optimizers.py`, which maps the same
names and kwargs onto optax).

A schedule is a closed form of the step count, evaluated on the host in
Python floats: the step reads it at the count *before* the update, as
`optax.adam` does, and no device value is read back.

Ported optimizers: Adam (Keras epsilon 1e-7, added outside the root of the
bias-corrected second moment) and SGD (momentum, nesterov), with the three
clip options. The state is a dict in the parameter tree's layout
(`{"count": int, "mu": tree, "nu": tree}` for Adam, `{"count", "trace"}` for
SGD with momentum), so checkpoints can cross between the packages.

`Optimizer.step` updates the parameters and the state **in place** (the JAX
package returns new trees; here the float32 masters and both moments are
held once). It is plain tensor code over the flattened leaves, batched with
`torch._foreach_*` so a step costs a handful of launches, not a dozen per
leaf.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from ..frontend.ir import OptimizerSpec, ScheduleSpec
from ..model.builder import flatten_params, map_params

Schedule = Callable[[int], float]


def _to_bool(v) -> bool:
    if isinstance(v, str):
        return v.lower() == "true"
    return bool(v)


def build_schedule(spec: ScheduleSpec) -> Schedule:
    """step count -> learning rate, the Keras schedule of that name."""
    p = dict(spec.params)
    kind = spec.kind
    if kind == "ExponentialDecay":
        init = float(p["initial_learning_rate"])
        steps = int(p["decay_steps"])
        rate = float(p["decay_rate"])
        staircase = _to_bool(p.get("staircase", False))
        if steps <= 0 or rate == 0:
            return lambda step: init

        def exponential(step):
            t = step / steps
            if staircase:
                t = math.floor(t)
            return init if step <= 0 else init * rate**t

        return exponential
    if kind == "InverseTimeDecay":
        # lr = init / (1 + rate * step / decay_steps)
        init = float(p["initial_learning_rate"])
        steps = int(p["decay_steps"])
        rate = float(p["decay_rate"])
        staircase = _to_bool(p.get("staircase", False))

        def inverse_time(step):
            t = step // steps if staircase else step / steps
            return init / (1.0 + rate * t)

        return inverse_time
    if kind == "PolynomialDecay":
        init = float(p["initial_learning_rate"])
        end = float(p.get("end_learning_rate", 0.0001))
        power = float(p.get("power", 1.0))
        steps = int(p["decay_steps"])
        if steps <= 0:
            return lambda step: init

        def polynomial(step):
            frac = 1 - min(max(step, 0), steps) / steps
            return (init - end) * frac**power + end

        return polynomial
    if kind == "PiecewiseConstantDecay":
        # keras boundary semantics are inclusive on the left value:
        # lr = values[i] while step <= boundaries[i]
        boundaries = [int(b) for b in p["boundaries"]]
        values = [float(v) for v in p["values"]]

        def piecewise(step):
            return values[sum(step > b for b in boundaries)]

        return piecewise
    if kind == "CosineDecay":
        init = float(p["initial_learning_rate"])
        steps = int(p["decay_steps"])
        alpha = float(p.get("alpha", 0.0))
        if not steps > 0:
            raise ValueError(f"CosineDecay requires positive decay_steps, got {steps}")

        def cosine(step):
            c = 0.5 * (1 + math.cos(math.pi * min(step, steps) / steps))
            return init * ((1 - alpha) * c + alpha)

        return cosine
    if kind == "CosineDecayRestarts":
        # keras closed form (SGDR, Loshchilov & Hutter): restart i runs for
        # first_decay_steps * t_mul^i steps at peak initial_lr * m_mul^i
        init = float(p["initial_learning_rate"])
        t0 = float(p["first_decay_steps"])
        t_mul = float(p.get("t_mul", 2.0))
        m_mul = float(p.get("m_mul", 1.0))
        alpha = float(p.get("alpha", 0.0))

        def restarts(step):
            cf = step / t0
            if t_mul == 1.0:
                i_restart = math.floor(cf)
                frac = cf - i_restart
            else:
                i_restart = math.floor(math.log1p(-cf * (1.0 - t_mul)) / math.log(t_mul))
                sum_r = (1.0 - t_mul**i_restart) / (1.0 - t_mul)
                frac = (cf - sum_r) / t_mul**i_restart
            m_fac = m_mul**i_restart
            c = 0.5 * (1.0 + math.cos(math.pi * frac))
            return init * ((1.0 - alpha) * m_fac * c + alpha)

        return restarts
    raise ValueError(f"unknown learning-rate schedule '{kind}'")


_KNOWN_OPT_KW = {
    "Adam": {"beta_1", "beta_2", "epsilon", "amsgrad"},
    "AdamW": {"beta_1", "beta_2", "epsilon", "weight_decay"},
    "SGD": {"momentum", "nesterov"},
    "RMSprop": {"rho", "epsilon", "momentum", "centered"},
    "Adagrad": {"initial_accumulator_value", "epsilon"},
    "Adadelta": {"rho", "epsilon"},
    "Adamax": {"beta_1", "beta_2", "epsilon"},
    "Nadam": {"beta_1", "beta_2", "epsilon"},
}
# keras base-optimizer kwargs honored for every kind (clipping runs before
# the update, keras's order); 'name' is cosmetic
_COMMON_OPT_KW = {"learning_rate", "clipnorm", "clipvalue", "global_clipnorm", "name"}


def _leaves(tree) -> List[torch.Tensor]:
    return list(flatten_params(tree).values())


def _zeros_like_tree(params):
    return map_params(torch.zeros_like, params)


class Optimizer:
    """One Keras optimizer: `init(params)` makes its state, `step(params,
    grads, state)` applies one update in place."""

    def __init__(
        self,
        kind: str,
        learning_rate: Union[float, Schedule],
        clip: Optional[tuple] = None,
        **hyper: Any,
    ):
        self.kind = kind
        self.learning_rate = learning_rate
        self.clip = clip  # (option name, value) or None
        self.hyper = hyper

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params) -> Dict[str, Any]:
        state: Dict[str, Any] = {"count": 0}
        if self.kind == "Adam":
            state["mu"] = _zeros_like_tree(params)
            state["nu"] = _zeros_like_tree(params)
        elif self.hyper["momentum"] > 0:
            state["trace"] = _zeros_like_tree(params)
        return state

    def _clipped(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.clip is None:
            return grads
        option, v = self.clip
        if option == "clipvalue":
            return [g.clamp(-v, v) for g in grads]
        if option == "clipnorm":  # each variable's gradient to max L2 norm v
            norms = torch._foreach_norm(grads)
            return [
                g * torch.clamp_max(v / torch.clamp_min(n, 1e-30), 1.0)
                for g, n in zip(grads, norms)
            ]
        # global_clipnorm, as optax.clip_by_global_norm
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        return [torch.where(norm < v, g, (g / norm) * v) for g in grads]

    @torch.no_grad()
    def step(self, params, grads, state: Dict[str, Any]) -> None:
        """params <- params + update(grads), in place; `grads` is a tree of
        the same layout. The learning rate is the schedule at the count
        before this update."""
        p = _leaves(params)
        g = self._clipped(_leaves(grads))
        lr = self.lr(state["count"])
        state["count"] += 1
        t = state["count"]
        if self.kind == "Adam":
            b1, b2, eps = self.hyper["b1"], self.hyper["b2"], self.hyper["eps"]
            mu, nu = _leaves(state["mu"]), _leaves(state["nu"])
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - b2)
            denom = torch._foreach_div(nu, 1 - b2**t)  # bias-corrected nu
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            torch._foreach_addcdiv_(p, mu, denom, value=-lr / (1 - b1**t))
            return
        momentum, nesterov = self.hyper["momentum"], self.hyper["nesterov"]
        if momentum > 0:
            trace = _leaves(state["trace"])
            torch._foreach_mul_(trace, momentum)
            torch._foreach_add_(trace, g)
            if nesterov:
                g = torch._foreach_add(g, trace, alpha=momentum)
            else:
                g = trace
        torch._foreach_add_(p, g, alpha=-lr)


def build_optimizer(spec: OptimizerSpec) -> Optimizer:
    p = {k: v for k, v in spec.params.items()}
    kind = spec.kind
    if kind not in _KNOWN_OPT_KW:
        raise ValueError(f"unknown optimizer '{kind}'")
    known = _KNOWN_OPT_KW[kind] | _COMMON_OPT_KW
    unknown = set(p) - known
    if unknown:
        # dropping them silently would train with other semantics than the
        # description asks for
        raise ValueError(
            f"unsupported {kind} option(s) {sorted(unknown)}; supported: "
            f"{sorted(known - {'name'})}"
        )
    clip_opts = [k for k in ("clipvalue", "clipnorm", "global_clipnorm") if k in p]
    if len(clip_opts) > 1:
        # keras's base optimizer raises here too
        raise ValueError(
            f"at most one of clipvalue/clipnorm/global_clipnorm may be set; "
            f"got {clip_opts}"
        )
    clip = (clip_opts[0], float(p[clip_opts[0]])) if clip_opts else None
    lr: Union[float, Schedule]
    if spec.schedule is not None:
        lr = build_schedule(spec.schedule)
    else:
        lr = float(p.get("learning_rate", 0.001))
    if kind == "Adam":
        if _to_bool(p.get("amsgrad", False)):
            raise NotImplementedError(
                "Adam with amsgrad is not ported to ignnition_tpu_torch yet"
            )
        return Optimizer(
            "Adam", lr, clip,
            b1=float(p.get("beta_1", 0.9)),
            b2=float(p.get("beta_2", 0.999)),
            eps=float(p.get("epsilon", 1e-7)),
        )
    if kind == "SGD":
        return Optimizer(
            "SGD", lr, clip,
            momentum=float(p.get("momentum", 0.0)),
            nesterov=_to_bool(p.get("nesterov", False)),
        )
    raise NotImplementedError(
        f"the {kind} optimizer is not ported to ignnition_tpu_torch yet"
    )
