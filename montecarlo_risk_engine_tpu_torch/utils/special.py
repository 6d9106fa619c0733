"""Special functions with a custom derivative rule: the Student-t CDF.

Counterpart of ``montecarlo_risk_engine_tpu/utils/special.py`` (the
reference's TCDFPytorch, an "external function on the AAD tape"): the
forward pass is a special function, and the derivative is pinned to the
exact Student-t pdf.

Torch has no ``betainc``, so :func:`t_cdf`'s forward computes the
regularised incomplete beta function I_z(df/2, 1/2), z = df / (df + x^2), on
the tensor's own device: the continued fraction of Numerical Recipes
(``betacf``) by the modified Lentz method, a fixed number of terms, in
torch ops, with no host round trip.

The value and the first derivative come from a ``torch.autograd.Function``
whose ``backward`` and ``jvp`` give the pdf (``generate_vmap_rule=True``
lets ``torch.func.vmap`` batch it).  PyTorch runs a Function's ``jvp`` with
forward gradients off, so an outer ``torch.func.jvp`` would not see the
tangent's own derivative, while ``backward`` is differentiated again by
``torch.autograd.grad(create_graph=True)``.  So that both modes give the
same higher derivatives, the Function's rules evaluate the pdf at the
detached point (first order only), and :func:`t_cdf` adds a term whose value
and first derivative are zero and whose higher derivatives are the pdf's:
with u = x - stop_gradient(x),

    u * sum_i w_i pdf(x0 + c_i u) - u * pdf(x0),

the two-point Gauss-Legendre rule for the integral of the pdf over [x0, x],
whose derivatives in u at u = 0 are exact through the fourth.  It is written
in differentiable torch ops (``lgamma``, ``log1p``), so second derivatives
are the pdf's derivative under ``torch.autograd.grad(create_graph=True)``,
nested ``torch.func.jvp`` and their mixtures.
"""

from __future__ import annotations

import math

import torch

# Terms of the continued fraction: it converges in O(sqrt(max(a, b)))
# terms on the side of the symmetry point it is evaluated on, so 200 keep
# double precision up to df ~ 1e4.
_CF_TERMS = 200
_FPMIN = 1e-300
# Two-point Gauss-Legendre nodes on [0, 1], each of weight 1/2.
_GAUSS_NODES = (0.5 - math.sqrt(3.0) / 6.0, 0.5 + math.sqrt(3.0) / 6.0)


def t_pdf(x: torch.Tensor, df: float) -> torch.Tensor:
    """Student-t density with ``df`` degrees of freedom."""
    half = torch.as_tensor(0.5 * (df + 1.0), dtype=x.dtype, device=x.device)
    log_norm = (torch.lgamma(half) - torch.lgamma(half - 0.5)
                - 0.5 * math.log(df * math.pi))
    return torch.exp(log_norm - half * torch.log1p(x * x / df))


def _betacf(a, b, x):
    """Continued fraction of I_x(a, b) (modified Lentz), elementwise."""
    def floor(v):
        return torch.where(v.abs() < _FPMIN, torch.full_like(v, _FPMIN), v)

    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / floor(1.0 - qab * x / qap)
    h = d
    for m in range(1, _CF_TERMS + 1):
        m2 = 2.0 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 / floor(1.0 + aa * d)
        c = floor(1.0 + aa / c)
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 / floor(1.0 + aa * d)
        c = floor(1.0 + aa / c)
        h = h * d * c
    return h


def betainc(a: float, b: float, x: torch.Tensor) -> torch.Tensor:
    """Regularised incomplete beta I_x(a, b) for x in [0, 1], elementwise:
    the continued fraction where it converges fast, else 1 - I_{1-x}(b, a)."""
    flip = x > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(flip, torch.full_like(x, b), torch.full_like(x, a))
    bb = torch.where(flip, torch.full_like(x, a), torch.full_like(x, b))
    xx = torch.where(flip, 1.0 - x, x)
    log_front = (math.lgamma(a + b) - torch.lgamma(aa) - torch.lgamma(bb)
                 + aa * torch.log(xx) + bb * torch.log1p(-xx))
    part = torch.exp(log_front) * _betacf(aa, bb, xx) / aa
    return torch.where(flip, 1.0 - part, part)


class _TCDF(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, df):
        tail = 0.5 * betainc(0.5 * df, 0.5, df / (df + x * x))
        return torch.where(x >= 0, 1.0 - tail, tail)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, df = inputs
        ctx.df = df
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * t_pdf(x.detach(), ctx.df), None

    @staticmethod
    def jvp(ctx, x_tangent, df_tangent):
        (x,) = ctx.saved_tensors
        return x_tangent * t_pdf(x.detach(), ctx.df)


def t_cdf(x: torch.Tensor, df: float) -> torch.Tensor:
    """Student-t CDF with ``df`` degrees of freedom (a float); its
    derivative in ``x`` is :func:`t_pdf`, to every order the transforms
    ask for up to the fourth."""
    df = float(df)
    x0 = x.detach()
    u = x - x0
    higher = u * (0.5 * sum(t_pdf(x0 + c * u, df) for c in _GAUSS_NODES) - t_pdf(x0, df))
    return _TCDF.apply(x, df) + higher
