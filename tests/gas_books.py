"""The gas books of tests/test_torch_exercise.py and how their results are
compared, for either package (``pkg``: the JAX package or the port).  This
module imports no JAX, so the card's tests use it too."""

import numpy as np


def s2f(pkg):
    return pkg.SchwartzTwoFactorModel(0.0, [0.0, 2.0], [10.0, 11.0], rate=0.02,
                                      short_term_mean_reversion=1.0, short_term_vol=0.4,
                                      long_term_drift=0.01, long_term_vol=0.2, rho=0.3,
                                      asset_id="gas")


def scan_storage(pkg, initial=3.0, num_states=6):
    """The storage of tests/test_storage_scan_equivalence.py."""
    cfg = pkg.StorageConfig()
    cfg.add_volume_constraint(0.0, 2.0, 0.0, 10.0)
    cfg.add_injection_flexibility(0.0, 2.0, 0.0, 3.0)
    cfg.add_injection_flexibility(0.0, 2.0, 6.0, 1.5)
    cfg.add_withdrawal_flexibility(0.0, 2.0, 0.0, 1.0)
    cfg.add_withdrawal_flexibility(0.0, 2.0, 6.0, 2.5)
    cfg.add_variable_injection_cost(0.0, 0.2)
    cfg.add_variable_withdrawal_cost(0.0, 0.15)
    return pkg.Storage(asset_id="gas", start_date=0.0, end_date=2.0, initial_amount=initial,
                       storage_config=cfg, num_states=num_states, rollout_interval=0.25)


def flexicall(pkg, rights=2, itm_only=False):
    unds = [pkg.EuropeanOption(pkg.Equity("gas"), t, 10.0 + k, pkg.OptionType.CALL, asset_id="gas")
            for k, t in enumerate([0.5, 1.0, 1.5])]
    return pkg.FlexiCall(unds, rights, asset_id="gas", itm_only_regression=itm_only)


def gas_book(pkg):
    return [pkg.NettingSet(name="storage", products=[scan_storage(pkg), scan_storage(pkg, 4.0)]),
            pkg.NettingSet(name="flexicall", products=[flexicall(pkg), flexicall(pkg, 1, True)])]


def pv_book(pkg):
    """(netting sets, model, metrics) of the gas book's PV."""
    return gas_book(pkg), s2f(pkg), pkg.RiskMetrics([pkg.PVMetric()])


def exposure_book(pkg):
    """(netting sets, model, metrics): a storage and a FlexiCall with EPE on
    7 dates (the exposure rows of the event tables)."""
    metrics = pkg.RiskMetrics([pkg.EPEMetric()], exposure_timeline=np.linspace(0.0, 1.8, 7))
    return ([pkg.NettingSet(name="s", products=[scan_storage(pkg), flexicall(pkg)])], s2f(pkg),
            metrics)


def compare_coeffs(products, ref_coeffs, spot0):
    """Each product's ``regression_coeffs`` against ``ref_coeffs``, rtol
    1e-8.  At t = 0 the explanatory spot is the constant ``spot0``: the
    basis has rank one, the ridge alone makes the Gram matrix invertible
    (condition ~1e10), and the coefficients carry ~1e-6 relative rounding,
    so that row is compared by the value it predicts, basis(spot0) @ c."""
    for product, ref in zip(products, ref_coeffs):
        ported = product.regression_coeffs.cpu().numpy()
        assert ported.shape == ref.shape
        for row, t in enumerate(product.regression_timeline):
            if t == 0.0:
                basis = spot0 ** np.arange(ref.shape[-1])
                np.testing.assert_allclose(ported[row] @ basis, ref[row] @ basis, rtol=1e-8,
                                           atol=1e-12)
            else:
                np.testing.assert_allclose(ported[row], ref[row], rtol=1e-8, atol=1e-12)


def compare(pr, jr, differentiate):
    """Results ``pr`` against ``jr``: values and errors rtol 1e-9, jacobians
    rtol 1e-7."""
    for ns in jr.get_netting_set_names():
        for metric in jr.get_metric_names():
            np.testing.assert_allclose(pr.get_results(ns, metric), jr.get_results(ns, metric),
                                       rtol=1e-9, atol=1e-13, err_msg=f"{ns} {metric}")
            np.testing.assert_allclose(pr.get_mc_error(ns, metric), jr.get_mc_error(ns, metric),
                                       rtol=1e-9, atol=1e-13, err_msg=f"{ns} {metric}")
            if differentiate:
                np.testing.assert_allclose(np.asarray(pr.get_derivatives(ns, metric)),
                                           np.asarray(jr.get_derivatives(ns, metric)),
                                           rtol=1e-7, atol=1e-10, err_msg=f"{ns} {metric}")
