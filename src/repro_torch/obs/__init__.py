"""Observability of the port's serving engines: the metrics registry
(``obs/metrics.py``) behind ``ServeEngine.stats``."""
