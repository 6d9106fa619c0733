"""Market-data loaders: Yahoo Finance, OptionsDX wide files, Kaggle datasets.

Counterpart of ``montecarlo_risk_engine_tpu/helpers/market_data.py`` (the
reference's ``src/helpers/{yf_dataloader, optiondx_dataloader,
kaggle_data_helper}.py``).  They feed calibration examples, never the
engine.  Every third-party package they use is optional and imported
inside the function that needs it, through :func:`_require`, so the package
imports on torch, numpy and scipy alone: pandas for the frames, yfinance and
kagglehub for the downloads.  A missing one raises ``ImportError`` naming
it.  Downloaded frames are cached as CSV under ``data_dir``, so repeat runs
are offline.
"""

from __future__ import annotations

import os

DEFAULT_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "data")


def _require(module_name: str):
    try:
        return __import__(module_name)
    except ImportError as exc:
        raise ImportError(
            f"Optional dependency '{module_name}' is required for this loader. "
            f"Install it or use cached CSVs."
        ) from exc


class YFDataLoader:
    """Yahoo-Finance option-chain loader with CSV caching
    (reference yf_dataloader.py:11-67)."""

    def __init__(self, relative_output_path: str, data_dir: str = DEFAULT_DATA_DIR):
        os.makedirs(data_dir, exist_ok=True)
        self.path = os.path.join(data_dir, relative_output_path)

    def get_spot(self, ticker: str) -> float:
        yf = _require("yfinance")
        history = yf.Ticker(ticker).history(period="1d")
        return float(history["Close"].iloc[-1])

    def load_option_chain(self, ticker: str, min_bid: float) -> "pd.DataFrame":
        """All expiries' calls/puts with mid prices, filtered on bid size."""
        yf = _require("yfinance")
        pd = _require("pandas")
        tk = yf.Ticker(ticker)
        frames = []
        for expiry in tk.options:
            chain = tk.option_chain(expiry)
            for kind, frame in (("C", chain.calls), ("P", chain.puts)):
                part = frame[["strike", "bid", "ask", "impliedVolatility"]].copy()
                part["option_type"] = kind
                part["expiry"] = pd.Timestamp(expiry)
                frames.append(part)
        df = pd.concat(frames, ignore_index=True)
        df = df[df["bid"] >= min_bid]
        df["mid"] = 0.5 * (df["bid"] + df["ask"])
        df.to_csv(self.path, index=False)
        return df

    def retrieve_data(self) -> "pd.DataFrame":
        return _require("pandas").read_csv(self.path, parse_dates=["expiry"])


class OptionDXDataLoader:
    """OptionsDX 'wide' txt parser: bracketed headers, call/put columns
    side-by-side; long format adds a put-call-parity forward per expiry
    (reference optiondx_dataloader.py:10-238)."""

    def __init__(self, relative_path: str, data_dir: str = DEFAULT_DATA_DIR):
        os.makedirs(data_dir, exist_ok=True)
        self.path = os.path.join(data_dir, relative_path)

    @staticmethod
    def _parse_date(series: "pd.Series") -> "pd.Series":
        pd = _require("pandas")
        if pd.api.types.is_numeric_dtype(series):
            as_str = series.astype("Int64").astype(str)
            return pd.to_datetime(as_str, format="%Y%m%d", errors="coerce")
        return pd.to_datetime(series.astype(str).str.strip(), errors="coerce")

    def load_wide(self) -> "pd.DataFrame":
        pd = _require("pandas")
        df = pd.read_csv(self.path, sep=",", engine="python", skipinitialspace=True)
        df.columns = [c.strip().strip("[]") for c in df.columns]
        for col in ("QUOTE_DATE", "EXPIRE_DATE"):
            if col not in df.columns:
                raise ValueError(f"Missing {col} column")
            df[col] = self._parse_date(df[col])
        for col in df.columns:
            if (
                col.startswith(("C_", "P_", "STRIKE", "DTE", "UNDERLYING"))
                and not col.endswith("SIZE")
            ):
                df[col] = pd.to_numeric(df[col], errors="coerce")
        return df

    def load_long(self, *, min_bid: float = 0.01, year_basis: float = 365.0) -> "pd.DataFrame":
        pd = _require("pandas")
        wide = self.load_wide()
        records = []
        for kind in ("C", "P"):
            bid, ask = f"{kind}_BID", f"{kind}_ASK"
            if bid not in wide.columns:
                continue
            sub = wide[wide[bid] >= min_bid]
            records.append(pd.DataFrame({
                "quote_date": sub["QUOTE_DATE"],
                "expiry": sub["EXPIRE_DATE"],
                "strike": sub["STRIKE"],
                "option_type": kind,
                "bid": sub[bid],
                "ask": sub[ask],
                "mid": 0.5 * (sub[bid] + sub[ask]),
                "underlying": sub.get("UNDERLYING_LAST"),
            }))
        long_df = pd.concat(records, ignore_index=True)
        long_df["time_to_expiry"] = (
            (long_df["expiry"] - long_df["quote_date"]).dt.days / year_basis
        )
        forwards = self._forward_per_expiry(long_df)
        return long_df.merge(forwards, on="expiry", how="left")

    @staticmethod
    def _forward_per_expiry(long_df: "pd.DataFrame") -> "pd.DataFrame":
        """Put-call-parity forward: F = K + (C - P) at the strike where
        |C - P| is smallest (reference optiondx_dataloader.py:170-217)."""
        pd = _require("pandas")
        rows = []
        for expiry, group in long_df.groupby("expiry"):
            calls = group[group["option_type"] == "C"].set_index("strike")["mid"]
            puts = group[group["option_type"] == "P"].set_index("strike")["mid"]
            strikes = calls.index.intersection(puts.index)
            if len(strikes) == 0:
                continue
            diff = (calls.loc[strikes] - puts.loc[strikes]).astype(float)
            k_star = diff.abs().idxmin()
            rows.append({"expiry": expiry, "forward": float(k_star + diff.loc[k_star])})
        return pd.DataFrame(rows)

    def retrieve_data(self) -> "pd.DataFrame":
        return self.load_long()


def download_and_retrieve_data_from_kaggle(
    handle: str, relative_output_path: str, data_dir: str = DEFAULT_DATA_DIR
) -> "pd.DataFrame":
    """Fetch a Kaggle dataset CSV, caching under ``data_dir``
    (reference kaggle_data_helper.py:11-81)."""
    pd = _require("pandas")
    os.makedirs(data_dir, exist_ok=True)
    cache_path = os.path.join(data_dir, relative_output_path)
    if os.path.exists(cache_path):
        return pd.read_csv(cache_path)
    kagglehub = _require("kagglehub")
    dataset_dir = kagglehub.dataset_download(handle)
    csvs = [f for f in os.listdir(dataset_dir) if f.endswith(".csv")]
    if not csvs:
        raise FileNotFoundError(f"No CSV files found in Kaggle dataset {handle}")
    df = pd.read_csv(os.path.join(dataset_dir, csvs[0]))
    df.to_csv(cache_path, index=False)
    return df
