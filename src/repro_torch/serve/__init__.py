from repro_torch.obs import MetricsRegistry, Tracer, write_trace
from repro_torch.serve.faults import (AllHostsLostError, FaultInjector,
                                      HostLostError, InjectedFaultError,
                                      RequestFailedError, RetryPolicy,
                                      SynthesisError, TransientFaultError,
                                      UnservedRequestError, is_transient)
from repro_torch.serve.service import SynthesisFuture, SynthesisService
from repro_torch.serve.steps import make_prefill_step, make_serve_step
from repro_torch.serve.store import SynthesisStore
from repro_torch.serve.synthesis import SynthesisEngine, SynthesisRequest
