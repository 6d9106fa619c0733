"""Diagnostic entry points of the port that run on a card
(``python -m montecarlo_risk_engine_tpu_torch.tools.<name>``)."""
