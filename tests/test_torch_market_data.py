"""The port's market-data loaders (helpers/market_data.py) against the JAX
package's on an OptionsDX wide file the test writes itself; the fetching
loaders raise a clear ImportError (yfinance and kagglehub are not
installed, and no run fetches); the module imports without pandas."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from montecarlo_risk_engine_tpu.helpers import market_data as jax_md
from montecarlo_risk_engine_tpu_torch.helpers import market_data as port_md

REPO = Path(__file__).resolve().parent.parent


def write_wide(path: Path, numeric_dates: bool) -> None:
    """An OptionsDX 'wide' file: bracketed headers, calls and puts side by
    side, two quote dates, three expiries, a bid under the filter, one
    strike without a put."""
    rs = np.random.default_rng(5)
    header = ("[QUOTE_DATE], [UNDERLYING_LAST], [EXPIRE_DATE], [DTE], [C_BID], [C_ASK], "
              "[C_SIZE], [STRIKE], [P_BID], [P_ASK], [P_SIZE]")
    lines = [header]
    for quote in ("2023-01-03",):
        for expiry, dte in (("2023-02-17", 45), ("2023-03-17", 73), ("2023-06-16", 164)):
            for strike in (380.0, 390.0, 400.0, 410.0, 420.0):
                spot = 395.0 + rs.normal()
                c = max(spot - strike, 0.0) + 5.0 + rs.random()
                p = max(strike - spot, 0.0) + 5.0 + rs.random()
                c_bid = 0.005 if strike == 420.0 and expiry == "2023-02-17" else c - 0.1
                p_bid = "" if strike == 380.0 and expiry == "2023-03-17" else f"{p - 0.1:.2f}"
                q = quote.replace("-", "") if numeric_dates else f" {quote}"
                e = expiry.replace("-", "") if numeric_dates else f" {expiry}"
                lines.append(f"{q}, {spot:.2f}, {e}, {dte}, {c_bid:.3f}, {c + 0.1:.2f}, 10 x 12, "
                             f"{strike}, {p_bid}, {p + 0.1:.2f}, 7 x 9")
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("numeric_dates", [False, True])
def test_optiondx_loader_matches_jax(tmp_path, numeric_dates):
    write_wide(tmp_path / "spy.txt", numeric_dates)
    port = port_md.OptionDXDataLoader("spy.txt", data_dir=str(tmp_path))
    ref = jax_md.OptionDXDataLoader("spy.txt", data_dir=str(tmp_path))
    wide = port.load_wide()
    pd.testing.assert_frame_equal(wide, ref.load_wide())
    assert wide["QUOTE_DATE"].notna().all() and wide["P_BID"].isna().sum() == 1
    for kw in ({}, {"min_bid": 0.5, "year_basis": 252.0}):
        long_df = port.load_long(**kw)
        pd.testing.assert_frame_equal(long_df, ref.load_long(**kw))
        assert np.isfinite(long_df["forward"]).all()
        pd.testing.assert_frame_equal(port_md.OptionDXDataLoader._forward_per_expiry(long_df),
                                      jax_md.OptionDXDataLoader._forward_per_expiry(long_df))
    pd.testing.assert_frame_equal(port.retrieve_data(), ref.retrieve_data())
    with pytest.raises(ValueError, match="QUOTE_DATE"):
        (tmp_path / "bad.txt").write_text("[STRIKE], [C_BID]\n1.0, 2.0\n")
        port_md.OptionDXDataLoader("bad.txt", data_dir=str(tmp_path)).load_wide()


def test_default_data_dir_is_the_jax_packages():
    assert port_md.DEFAULT_DATA_DIR == jax_md.DEFAULT_DATA_DIR == str(REPO / "tests" / "data")


def test_fetching_loaders_raise_import_error(tmp_path):
    yf = port_md.YFDataLoader("chain.csv", data_dir=str(tmp_path))
    with pytest.raises(ImportError, match="yfinance"):
        yf.get_spot("SPY")
    with pytest.raises(ImportError, match="yfinance"):
        yf.load_option_chain("SPY", 0.05)
    with pytest.raises(ImportError, match="kagglehub"):
        port_md.download_and_retrieve_data_from_kaggle("owner/dataset", "k.csv",
                                                       data_dir=str(tmp_path))
    # a cached download is read back without fetching
    cached = pd.DataFrame({"a": [1, 2], "b": [0.5, 1.5]})
    cached.to_csv(tmp_path / "k.csv", index=False)
    pd.testing.assert_frame_equal(
        port_md.download_and_retrieve_data_from_kaggle("owner/dataset", "k.csv",
                                                       data_dir=str(tmp_path)), cached)
    # a cached chain is read back with its expiry parsed
    chain = pd.DataFrame({"strike": [100.0], "expiry": [pd.Timestamp("2024-01-19")]})
    chain.to_csv(tmp_path / "chain.csv", index=False)
    pd.testing.assert_frame_equal(yf.retrieve_data(),
                                  jax_md.YFDataLoader("chain.csv", str(tmp_path)).retrieve_data())


def test_module_imports_without_pandas(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['jax'] = None\n"
        "from montecarlo_risk_engine_tpu_torch.helpers import market_data as md\n"
        f"loader = md.OptionDXDataLoader('x.txt', data_dir={str(tmp_path)!r})\n"
        "try:\n"
        "    loader.load_wide()\n"
        "except ImportError as exc:\n"
        "    print('ImportError', exc)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "ImportError" in proc.stdout and "'pandas'" in proc.stdout
