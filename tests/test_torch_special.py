"""The port's Student-t CDF (utils/special.py) against scipy and the JAX
package: the value, its derivative (the pdf) and its second derivative (the
pdf's derivative) under every transform that asks for them (mirrors
tests/test_tcdf_and_named_access.py:18,26)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import scipy.stats
import torch
from torch.func import grad, jvp, vmap

from montecarlo_risk_engine_tpu.utils.special import t_cdf as jax_t_cdf
from montecarlo_risk_engine_tpu_torch.utils.special import betainc, t_cdf, t_pdf

torch.set_num_threads(1)

DFS = (2.0, 5.0, 11.5, 150.0)


def pdf_derivative(x, df):
    """d/dx of the Student-t pdf: -pdf (df + 1) x / (df + x^2)."""
    return -scipy.stats.t.pdf(x, df) * (df + 1.0) * x / (df + x * x)


@pytest.mark.parametrize("df", DFS)
def test_t_cdf_matches_scipy_and_jax(df):
    xs = np.linspace(-4.0, 4.0, 41)
    ours = t_cdf(torch.from_numpy(xs), df).numpy()
    np.testing.assert_allclose(ours, scipy.special.stdtr(df, xs), rtol=0, atol=1e-10)
    np.testing.assert_allclose(ours, np.asarray(jax_t_cdf(jnp.asarray(xs), df)), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(t_pdf(torch.from_numpy(xs), df).numpy(),
                               scipy.stats.t.pdf(xs, df), rtol=1e-12)


def test_betainc_matches_scipy_on_both_sides_of_the_symmetry_point():
    x = np.linspace(0.0, 1.0, 101)
    for a, b in ((0.5, 0.5), (2.5, 0.5), (40.0, 3.0), (0.7, 12.0)):
        np.testing.assert_allclose(betainc(a, b, torch.from_numpy(x)).numpy(),
                                   scipy.special.betainc(a, b, x), rtol=1e-11, atol=1e-14)


def test_t_cdf_gradient_is_pdf():
    xs = np.linspace(-3.0, 3.0, 13)
    df = 4.0
    pdf = scipy.stats.t.pdf(xs, df)
    x = torch.from_numpy(xs).requires_grad_(True)
    (g,) = torch.autograd.grad(t_cdf(x, df).sum(), x)
    np.testing.assert_allclose(g.numpy(), pdf, rtol=0, atol=1e-10)
    np.testing.assert_allclose(vmap(grad(lambda y: t_cdf(y, df)))(x.detach()).numpy(), pdf,
                               rtol=0, atol=1e-10)
    _, tangent = jvp(lambda y: t_cdf(y, df), (x.detach(),), (torch.ones_like(x),))
    np.testing.assert_allclose(tangent.numpy(), pdf, rtol=0, atol=1e-10)
    eps = 1e-6
    fd = (scipy.special.stdtr(df, xs + eps) - scipy.special.stdtr(df, xs - eps)) / (2 * eps)
    np.testing.assert_allclose(g.numpy(), fd, rtol=0, atol=1e-6)


def test_t_cdf_second_derivative_is_pdf_derivative():
    xs = np.linspace(-3.0, 3.0, 13)
    df = 4.0
    ref = pdf_derivative(xs, df)
    x = torch.from_numpy(xs)
    ones = torch.ones_like(x)

    xr = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(t_cdf(xr, df).sum(), xr, create_graph=True)
    (h,) = torch.autograd.grad(g.sum(), xr)
    np.testing.assert_allclose(h.numpy(), ref, rtol=0, atol=1e-9)

    first = lambda y: jvp(lambda z: t_cdf(z, df), (y,), (ones,))[1]
    _, h_fwd = jvp(first, (x,), (ones,))
    np.testing.assert_allclose(h_fwd.numpy(), ref, rtol=0, atol=1e-9)

    # forward over reverse, the Hessian rows' reverse branch
    g_fn = grad(lambda z: t_cdf(z, df))
    _, h_mixed = jvp(vmap(g_fn), (x,), (ones,))
    np.testing.assert_allclose(h_mixed.numpy(), ref, rtol=0, atol=1e-9)


def test_t_cdf_under_vmap():
    rs = np.random.default_rng(3)
    xs = rs.standard_normal((5, 7)) * 2.0
    out = vmap(lambda row: t_cdf(row, 6.5))(torch.from_numpy(xs))
    np.testing.assert_allclose(out.numpy(), scipy.special.stdtr(6.5, xs), rtol=0, atol=1e-10)
