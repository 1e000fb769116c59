"""Optimizers and learning-rate schedules, resolved by Keras class name
(counterpart of `ignnition_tpu/training/optimizers.py`, which maps the same
names and kwargs onto optax).

Every number that changes from step to step lives on the parameters'
device, as optax keeps its count there: the state's `count` is a 0-d int32
tensor, Nadam's `u_prod` a 0-d float32 tensor, a schedule is a closed form
of the count tensor (f64 tensor arithmetic), and the step sizes and bias
corrections are 0-d tensors fed to the `Tensor` overloads of
`torch._foreach_*`. So a step reads nothing back to the host and can be
captured in a CUDA graph (`training.capture`) and replayed: a Python number
would be frozen at the capture. The step reads the schedule at the count
*before* the update, as optax does. Constants (the betas, epsilon, a fixed
learning rate, the clip values) stay Python numbers.

Every optimizer of the JAX package, with its arithmetic: Adam (Keras epsilon
1e-7, added outside the root of the bias-corrected second moment; with
`amsgrad` the Keras form, which maxes the raw second moment), AdamW
(optax's `adamw`: decoupled weight decay, default 0.004, on every leaf),
SGD (momentum, nesterov), RMSprop (optax's: epsilon inside the root, the
centered variant, momentum over the learning-rate-scaled update), Adagrad
(initial accumulator 0.1), Adadelta, Adamax and Nadam (the Keras form with
its momentum-schedule product `u_prod`), each after the three clip options.
The state is a dict in the parameter tree's layout: `count`, then the
kind's trees (`mu`, `nu`, `vhat`, `trace`, `sum_of_squares`, `e_g`, `e_x`)
and for Nadam `u_prod`, so that `torch.save` checkpoints carry it as it is.
A state whose `count` is a Python int and `u_prod` a float (a checkpoint
written before these were tensors) is taken: the trainer copies such
values into the live tensors, and `Optimizer.step` makes tensors of them.

`Optimizer.step` updates the parameters and the state **in place** (the JAX
package returns new trees; here the float32 masters and the moments are
held once). It is plain tensor code over the flattened leaves, batched with
`torch._foreach_*` so a step costs a handful of launches, not a dozen per
leaf.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import torch

from ..frontend.ir import OptimizerSpec, ScheduleSpec
from ..model.builder import flatten_params, map_params

Number = Union[float, torch.Tensor]
Schedule = Callable[[Union[int, torch.Tensor]], torch.Tensor]


def _to_bool(v) -> bool:
    if isinstance(v, str):
        return v.lower() == "true"
    return bool(v)


def _f64(step) -> torch.Tensor:
    """A step count (an int, or a tensor on any device) as a 0-d f64 tensor
    on its device."""
    if isinstance(step, torch.Tensor):
        return step.to(torch.float64)
    return torch.tensor(float(step), dtype=torch.float64)


def build_schedule(spec: ScheduleSpec) -> Schedule:
    """step count -> learning rate, the Keras schedule of that name, as a 0-d
    f64 tensor on the count's device (the CPU for an int count)."""
    p = dict(spec.params)
    kind = spec.kind
    if kind == "ExponentialDecay":
        init = float(p["initial_learning_rate"])
        steps = int(p["decay_steps"])
        rate = float(p["decay_rate"])
        staircase = _to_bool(p.get("staircase", False))
        if steps <= 0 or rate == 0:
            return lambda step: torch.full_like(_f64(step), init)

        def exponential(step):
            s = _f64(step)
            t = s / steps
            if staircase:
                t = torch.floor(t)
            return torch.where(s <= 0, init, init * torch.pow(rate, t))

        return exponential
    if kind == "InverseTimeDecay":
        # lr = init / (1 + rate * step / decay_steps)
        init = float(p["initial_learning_rate"])
        steps = int(p["decay_steps"])
        rate = float(p["decay_rate"])
        staircase = _to_bool(p.get("staircase", False))

        def inverse_time(step):
            t = _f64(step) / steps
            if staircase:
                t = torch.floor(t)
            return init / (1.0 + rate * t)

        return inverse_time
    if kind == "PolynomialDecay":
        init = float(p["initial_learning_rate"])
        end = float(p.get("end_learning_rate", 0.0001))
        power = float(p.get("power", 1.0))
        steps = int(p["decay_steps"])
        if steps <= 0:
            return lambda step: torch.full_like(_f64(step), init)

        def polynomial(step):
            frac = 1 - _f64(step).clamp(0, steps) / steps
            return (init - end) * frac**power + end

        return polynomial
    if kind == "PiecewiseConstantDecay":
        # keras boundary semantics are inclusive on the left value:
        # lr = values[i] while step <= boundaries[i]
        boundaries = [int(b) for b in p["boundaries"]]
        values = [float(v) for v in p["values"]]

        def piecewise(step):
            s = _f64(step)
            passed = sum((s > b).to(torch.int64) for b in boundaries)
            out = torch.full_like(s, values[0])
            for i in range(1, len(values)):
                out = torch.where(passed == i, values[i], out)
            return out

        return piecewise
    if kind == "CosineDecay":
        init = float(p["initial_learning_rate"])
        steps = int(p["decay_steps"])
        alpha = float(p.get("alpha", 0.0))
        if not steps > 0:
            raise ValueError(f"CosineDecay requires positive decay_steps, got {steps}")

        def cosine(step):
            c = 0.5 * (1 + torch.cos(math.pi * _f64(step).clamp_max(steps) / steps))
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
            cf = _f64(step) / t0
            if t_mul == 1.0:
                i_restart = torch.floor(cf)
                frac = cf - i_restart
            else:
                i_restart = torch.floor(torch.log1p(-cf * (1.0 - t_mul)) / math.log(t_mul))
                sum_r = (1.0 - torch.pow(t_mul, i_restart)) / (1.0 - t_mul)
                frac = (cf - sum_r) / torch.pow(t_mul, i_restart)
            m_fac = torch.pow(m_mul, i_restart)
            c = 0.5 * (1.0 + torch.cos(math.pi * frac))
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


# the state's trees by kind (beyond `count`); RMSprop's depend on its options
_STATE_TREES = {
    "Adam": ("mu", "nu"),
    "AdamW": ("mu", "nu"),
    "Adamax": ("mu", "nu"),
    "Nadam": ("mu", "nu"),
    "Adadelta": ("e_g", "e_x"),
}


def _add_scaled_(p: List[torch.Tensor], u: List[torch.Tensor], s: Number) -> None:
    """p <- p + s u in place. A Python number rides `alpha`; a 0-d tensor
    cannot (`alpha` would read it back to the host), so u is scaled first."""
    if isinstance(s, torch.Tensor):
        torch._foreach_add_(p, torch._foreach_mul(u, s))
    else:
        torch._foreach_add_(p, u, alpha=s)


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

    def lr(self, count) -> Number:
        """The learning rate at `count`: a Python float when it is constant,
        else the schedule's 0-d f64 tensor on the count's device."""
        lr = self.learning_rate
        return lr(count) if callable(lr) else float(lr)

    def init(self, params) -> Dict[str, Any]:
        h = self.hyper
        leaves = _leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")
        state: Dict[str, Any] = {"count": torch.zeros((), dtype=torch.int32, device=device)}
        trees = list(_STATE_TREES.get(self.kind, ()))
        if self.kind == "Adam" and h["amsgrad"]:
            trees.append("vhat")
        if self.kind == "RMSprop":
            trees = ["nu"] + (["mu"] if h["centered"] else [])
        if self.kind in ("SGD", "RMSprop") and h["momentum"] > 0:
            trees.append("trace")
        for name in trees:
            state[name] = _zeros_like_tree(params)
        if self.kind == "Adagrad":
            state["sum_of_squares"] = map_params(
                lambda v: torch.full_like(v, h["initial_accumulator_value"]), params
            )
        if self.kind == "Nadam":
            state["u_prod"] = torch.ones((), dtype=torch.float32, device=device)
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
        before this update. Nothing is read back to the host."""
        p = _leaves(params)
        g = self._clipped(_leaves(grads))
        device = p[0].device if p else torch.device("cpu")
        for name, dtype in (("count", torch.int32), ("u_prod", torch.float32)):
            v = state.get(name)
            if v is not None and not (isinstance(v, torch.Tensor) and v.device == device):
                state[name] = torch.as_tensor(v, dtype=dtype).to(device)
        lr = self.lr(state["count"])
        state["count"].add_(1)
        t = state["count"].to(torch.float64)
        trees = {k: _leaves(v) for k, v in state.items() if isinstance(v, Mapping)}
        dtype = p[0].dtype if p else torch.float32
        getattr(self, f"_{self.kind.lower()}")(p, g, lr, t, dtype, state, **trees)

    @staticmethod
    def _moments(g, mu, nu, b1, b2) -> None:
        """mu <- b1 mu + (1 - b1) g; nu <- b2 nu + (1 - b2) g^2, in place."""
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)

    @staticmethod
    def _corrected_root(nu, b2, t, eps, dtype) -> List[torch.Tensor]:
        """sqrt(nu / (1 - b2^t)) + eps: the bias-corrected second moment's root."""
        denom = torch._foreach_div(nu, (1 - torch.pow(b2, t)).to(dtype))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        return denom

    def _adam(self, p, g, lr, t, dtype, state, mu, nu, vhat=None) -> None:
        b1, b2, eps = self.hyper["b1"], self.hyper["b2"], self.hyper["eps"]
        self._moments(g, mu, nu, b1, b2)
        if vhat is not None:
            # Keras AMSGrad: the raw second moment's running max, the bias
            # corrections in the step size, epsilon outside the root
            torch._foreach_maximum_(vhat, nu)
            denom = torch._foreach_sqrt(vhat)
            torch._foreach_add_(denom, eps)
            alpha = lr * torch.sqrt(1 - torch.pow(b2, t)) / (1 - torch.pow(b1, t))
        else:
            denom = self._corrected_root(nu, b2, t, eps, dtype)
            alpha = lr / (1 - torch.pow(b1, t))
        update = torch._foreach_div(mu, denom)
        torch._foreach_mul_(update, (-alpha).to(dtype))
        torch._foreach_add_(p, update)

    def _adamw(self, p, g, lr, t, dtype, state, mu, nu) -> None:
        """optax.adamw: the Adam direction plus weight_decay * p, times -lr."""
        b1, b2, eps = self.hyper["b1"], self.hyper["b2"], self.hyper["eps"]
        self._moments(g, mu, nu, b1, b2)
        denom = self._corrected_root(nu, b2, t, eps, dtype)
        update = torch._foreach_div(mu, denom)
        torch._foreach_mul_(update, (1 / (1 - torch.pow(b1, t))).to(dtype))
        torch._foreach_add_(update, p, alpha=self.hyper["weight_decay"])
        _add_scaled_(p, update, _cast(-lr, dtype))

    def _sgd(self, p, g, lr, t, dtype, state, trace=None) -> None:
        if trace is not None:
            torch._foreach_mul_(trace, self.hyper["momentum"])
            torch._foreach_add_(trace, g)
            if self.hyper["nesterov"]:
                g = torch._foreach_add(g, trace, alpha=self.hyper["momentum"])
            else:
                g = trace
        _add_scaled_(p, g, _cast(-lr, dtype))

    def _rmsprop(self, p, g, lr, t, dtype, state, nu, mu=None, trace=None) -> None:
        """optax.rmsprop: g / sqrt(nu + eps) (centered: nu - mu^2 + eps),
        scaled by -lr, then the momentum trace of the scaled updates."""
        rho, eps = self.hyper["rho"], self.hyper["eps"]
        torch._foreach_mul_(nu, rho)
        torch._foreach_addcmul_(nu, g, g, value=1 - rho)
        var = nu
        if mu is not None:
            torch._foreach_mul_(mu, rho)
            torch._foreach_add_(mu, g, alpha=1 - rho)
            var = torch._foreach_addcmul(nu, mu, mu, value=-1.0)
        var = torch._foreach_add(var, eps)
        torch._foreach_rsqrt_(var)
        update = torch._foreach_mul(var, g)
        torch._foreach_mul_(update, _cast(-lr, dtype))
        if trace is not None:
            torch._foreach_mul_(trace, self.hyper["momentum"])
            torch._foreach_add_(trace, update)
            update = trace
        torch._foreach_add_(p, update)

    def _adagrad(self, p, g, lr, t, dtype, state, sum_of_squares) -> None:
        """optax.adagrad: g / sqrt(sum of squares + eps), 0 where the sum is 0."""
        torch._foreach_addcmul_(sum_of_squares, g, g)
        eps = self.hyper["eps"]
        scaled = [
            torch.where(si > 0, torch.rsqrt(si + eps), torch.zeros_like(si)) * gi
            for gi, si in zip(g, sum_of_squares)
        ]
        _add_scaled_(p, scaled, _cast(-lr, dtype))

    def _adadelta(self, p, g, lr, t, dtype, state, e_g, e_x) -> None:
        """optax.adadelta: g * sqrt(e_x + eps) / sqrt(e_g + eps), then e_x
        takes the update's square."""
        rho, eps = self.hyper["rho"], self.hyper["eps"]
        torch._foreach_mul_(e_g, rho)
        torch._foreach_addcmul_(e_g, g, g, value=1 - rho)
        num = torch._foreach_add(e_x, eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, eps)
        torch._foreach_sqrt_(den)
        update = torch._foreach_div(num, den)
        torch._foreach_mul_(update, g)
        torch._foreach_mul_(e_x, rho)
        torch._foreach_addcmul_(e_x, update, update, value=1 - rho)
        _add_scaled_(p, update, _cast(-lr, dtype))

    def _adamax(self, p, g, lr, t, dtype, state, mu, nu) -> None:
        """optax.adamax: nu <- max(|g| + eps, b2 nu); the bias-corrected mu
        over nu."""
        b1, b2, eps = self.hyper["b1"], self.hyper["b2"], self.hyper["eps"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        a = torch._foreach_abs(g)
        torch._foreach_add_(a, eps)
        torch._foreach_maximum_(nu, a)
        update = torch._foreach_div(mu, nu)
        torch._foreach_mul_(update, (-lr / (1 - torch.pow(b1, t))).to(dtype))
        torch._foreach_add_(p, update)

    def _nadam(self, p, g, lr, t, dtype, state, mu, nu) -> None:
        """Keras Nadam (keras/src/optimizers/nadam.py) with the momentum
        schedule u_t = b1 (1 - 0.5 * 0.96^t) and its running product, kept in
        float32 as the JAX package keeps it (this step's coefficients take
        the product before it is rounded)."""
        b1, b2, eps = self.hyper["b1"], self.hyper["b2"], self.hyper["eps"]
        u_t = b1 * (1.0 - 0.5 * torch.pow(0.96, t))
        u_t1 = b1 * (1.0 - 0.5 * torch.pow(0.96, t + 1))
        u_prod = state["u_prod"].to(torch.float64) * u_t
        u_prod1 = u_prod * u_t1
        state["u_prod"].copy_(u_prod)
        self._moments(g, mu, nu, b1, b2)
        m_hat = torch._foreach_mul(mu, (u_t1 / (1 - u_prod1)).to(dtype))
        torch._foreach_add_(m_hat, torch._foreach_mul(g, ((1 - u_t) / (1 - u_prod)).to(dtype)))
        denom = self._corrected_root(nu, b2, t, eps, dtype)
        update = torch._foreach_div(m_hat, denom)
        _add_scaled_(p, update, _cast(-lr, dtype))


def _cast(s: Number, dtype: torch.dtype) -> Number:
    """A step size in the parameters' dtype: a 0-d tensor cast, a Python
    number as it is (the kernels round it)."""
    return s.to(dtype) if isinstance(s, torch.Tensor) else s


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
    b = lambda: dict(
        b1=float(p.get("beta_1", 0.9)),
        b2=float(p.get("beta_2", 0.999)),
        eps=float(p.get("epsilon", 1e-7)),
    )
    if kind == "Adam":
        return Optimizer("Adam", lr, clip, amsgrad=_to_bool(p.get("amsgrad", False)), **b())
    if kind == "AdamW":
        return Optimizer(
            "AdamW", lr, clip, weight_decay=float(p.get("weight_decay", 0.004)), **b()
        )
    if kind == "SGD":
        return Optimizer(
            "SGD", lr, clip,
            momentum=float(p.get("momentum", 0.0)),
            nesterov=_to_bool(p.get("nesterov", False)),
        )
    if kind == "RMSprop":
        return Optimizer(
            "RMSprop", lr, clip,
            rho=float(p.get("rho", 0.9)),
            eps=float(p.get("epsilon", 1e-7)),
            momentum=float(p.get("momentum", 0.0)),
            centered=_to_bool(p.get("centered", False)),
        )
    if kind == "Adagrad":
        return Optimizer(
            "Adagrad", lr, clip,
            initial_accumulator_value=float(p.get("initial_accumulator_value", 0.1)),
            eps=float(p.get("epsilon", 1e-7)),
        )
    if kind == "Adadelta":
        return Optimizer(
            "Adadelta", lr, clip,
            rho=float(p.get("rho", 0.95)), eps=float(p.get("epsilon", 1e-7)),
        )
    return Optimizer(kind, lr, clip, **b())  # Adamax, Nadam
