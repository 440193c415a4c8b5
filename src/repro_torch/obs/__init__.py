"""Observability for the port's serving stack: span tracing
(``obs/trace.py``), typed metrics with latency quantiles
(``obs/metrics.py``), and Perfetto-loadable timeline export
(``obs/export.py``)."""
from repro_torch.obs.export import (chrome_trace, metrics_json,
                                    validate_chrome_trace, write_trace)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, default_buckets)
from repro_torch.obs.trace import (LIFECYCLE_STAGES, FakeClock, Span, Tracer,
                                   NULL_SPAN)
