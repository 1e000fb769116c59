"""What the plain references share: the precision they compute in, Keras'
dense layers and GRU, Keras' Adam under its learning-rate schedule, and the
three training steps that the benchmark compares.

Plain PyTorch in float32 with TF32 off, written from the published model
descriptions and Keras' documented arithmetic. Nothing of the program under
test is imported: the reference works out its own index structures from the
raw samples (`gnnbench.generate`) and takes the initial weights that the
benchmark made, never the program's.

`rounding` names the precision: "float32" computes plainly. The others round
the weights and every activation where the program would hold them in its
compute type, the gradient passing each rounding unchanged: "tf32" to the
10-bit significand of TF32, as the tensor cores' TF32 mode rounds the inputs
of a matrix product, and "float8" to float8 e4m3 (saturating at +-448). They
are the controls of the benchmark's comparison (`CONTROLS`): the reference one
precision below the one its configuration states.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

ACTIVATIONS = {
    None: lambda x: x,
    "None": lambda x: x,
    "linear": lambda x: x,
    "relu": F.relu,
    "selu": F.selu,
}

_FP8_MAX = 448.0
# a configuration's compute type -> the precision its control computes in
CONTROLS = {"float32": "tf32", "bfloat16": "float8"}


class _Float8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clamp(-_FP8_MAX, _FP8_MAX).to(torch.float8_e4m3fn).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _Tf32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        # round to nearest even at the 13 low bits of float32's 23-bit significand
        i = x.float().contiguous().view(torch.int32)
        i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
        return i.view(torch.float32).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad


def roundings() -> Dict[str, Callable[[torch.Tensor], torch.Tensor]]:
    return {"float32": lambda x: x, "tf32": _Tf32.apply, "float8": _Float8.apply}


def plain_float32() -> None:
    """Matrix products in true float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dense(x, kernel, bias, act, rnd):
    """Keras Dense: act(x @ kernel + bias)."""
    y = rnd(x @ kernel)
    if bias is not None:
        y = rnd(y + bias)
    return rnd(ACTIVATIONS[act](y))


def mlp(x, layers: List[dict], params: Params, prefix: str, rnd):
    """A stack of Dense layers (`layers`: the description's nn_architecture),
    weights under `<prefix>/layers/<j>/kernel` and `.../bias`."""
    for j, layer in enumerate(layers):
        if layer["type_layer"] != "Dense":
            raise ValueError(f"the reference holds Dense layers only, not {layer['type_layer']}")
        bias = params.get(f"{prefix}/layers/{j}/bias")
        x = dense(x, params[f"{prefix}/layers/{j}/kernel"], bias, layer.get("activation"), rnd)
    return x


def mlp_spec(layers: List[dict], prefix: str, in_dim: int, last_units=None) -> Dict[str, tuple]:
    """{name: (shape, init)} of a Dense stack, Keras' initializers: glorot
    uniform kernels, zero biases."""
    spec = {}
    for j, layer in enumerate(layers):
        units = int(layer["units"])
        if j == len(layers) - 1 and last_units is not None:
            units = last_units
        spec[f"{prefix}/layers/{j}/kernel"] = ((in_dim, units), "glorot")
        spec[f"{prefix}/layers/{j}/bias"] = ((units,), "zeros")
        in_dim = units
    return spec


def l2(layers: List[dict], params: Params, prefix: str) -> torch.Tensor:
    """Keras' l2 kernel regularizers of a Dense stack, on the float32 weights."""
    total = torch.zeros((), dtype=torch.float32, device=next(iter(params.values())).device)
    for j, layer in enumerate(layers):
        rate = float(layer.get("kernel_regularizer", 0.0) or 0.0)
        if rate > 0.0:
            total = total + rate * torch.sum(params[f"{prefix}/layers/{j}/kernel"] ** 2)
    return total


def gru_spec(prefix: str, in_dim: int, units: int) -> Dict[str, tuple]:
    return {
        f"{prefix}/kernel": ((in_dim, 3 * units), "glorot"),
        f"{prefix}/recurrent_kernel": ((units, 3 * units), "glorot"),
        f"{prefix}/bias": ((2, 3 * units), "zeros"),
    }


def gru(x, h, params: Params, prefix: str, rnd):
    """Keras GRU cell with reset_after=True, gates in the order z, r, h."""
    xw = rnd(x @ params[f"{prefix}/kernel"] + params[f"{prefix}/bias"][0])
    hw = rnd(h @ params[f"{prefix}/recurrent_kernel"] + params[f"{prefix}/bias"][1])
    xz, xr, xh = torch.chunk(xw, 3, dim=-1)
    hz, hr, hh = torch.chunk(hw, 3, dim=-1)
    z = rnd(torch.sigmoid(xz + hz))
    r = rnd(torch.sigmoid(xr + hr))
    cand = rnd(torch.tanh(xh + r * hh))
    return rnd(z * h + (1.0 - z) * cand)


class Adam:
    """Keras Adam (epsilon outside the root of the bias-corrected second
    moment) at the learning rate of its ExponentialDecay schedule for the
    step count before the update."""

    def __init__(self, optimizer: dict):
        schedule = optimizer.get("schedule") or {}
        if optimizer["type"] != "Adam" or schedule.get("type") != "ExponentialDecay":
            raise ValueError(f"the reference holds Adam under ExponentialDecay only, not "
                             f"{optimizer['type']} under {schedule.get('type')}")
        self.b1 = float(optimizer.get("beta_1", 0.9))
        self.b2 = float(optimizer.get("beta_2", 0.999))
        self.eps = float(optimizer.get("epsilon", 1e-7))
        self.schedule = schedule
        self.count = 0

    def lr(self) -> float:
        s = self.schedule
        t = self.count / int(s["decay_steps"])
        if str(s.get("staircase", "False")).lower() == "true":
            t = math.floor(t)
        return float(s["initial_learning_rate"]) * float(s["decay_rate"]) ** t

    @torch.no_grad()
    def step(self, params: Params, grads: Params, mu: Params, nu: Params) -> None:
        lr = self.lr()
        self.count += 1
        t = self.count
        for k, p in params.items():
            g = grads[k]
            mu[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = torch.sqrt(nu[k] / (1 - self.b2 ** t)) + self.eps
            p.add_(mu[k] / denom, alpha=-lr / (1 - self.b1 ** t))


def train(loss_fn, params0: Params, batches: list, optimizer: dict, rounding: str = "float32",
          steps: int = 3) -> dict:
    """`steps` training steps from `params0` over `batches[0..steps-1]`:
    {"loss": [each step's data loss], "grad1": {leaf: the first step's
    gradient}, "delta": {leaf: the change of the parameters after the
    steps}}. `loss_fn(params, batch, rnd) -> (data loss, regularization)`."""
    plain_float32()
    rnd = roundings()[rounding]
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    mu = {k: torch.zeros_like(v) for k, v in params0.items()}
    nu = {k: torch.zeros_like(v) for k, v in params0.items()}
    adam = Adam(optimizer)
    losses, grad1 = [], None
    for i in range(steps):
        loss, reg = loss_fn(params, batches[i], rnd)
        grads = torch.autograd.grad(loss + reg, list(params.values()), allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                 for k, g in zip(params, grads)}
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        adam.step(params, grads, mu, nu)
    delta = {k: (params[k].detach() - params0[k]) for k in params}
    return {"loss": losses, "grad1": grad1, "delta": delta}
