"""Serving stack of the port: the continuous-batching engine, the paged KV
pool with its prefix cache, the streaming front end, the energy control
plane and the declarative specs."""
from repro_torch.serve.control import EnergyBudgetController
from repro_torch.serve.engine import (GenRequest, GenResult, ServingEngine,
                                      make_pool_copy, prefill_bucket,
                                      view_bucket)
from repro_torch.serve.kv_pool import BlockPool, PagedKV
from repro_torch.serve.sampling import sample_tokens
from repro_torch.serve.scheduler import RejectedError, Scheduler, Slot
from repro_torch.serve.server import RequestHandle, StreamingServer
from repro_torch.serve.spec import MatrixSpec, ScenarioSpec, ServeSpec

__all__ = ["BlockPool", "EnergyBudgetController", "GenRequest", "GenResult",
           "MatrixSpec", "PagedKV", "RejectedError", "RequestHandle",
           "ScenarioSpec", "Scheduler", "ServeSpec", "ServingEngine", "Slot",
           "StreamingServer", "make_pool_copy", "prefill_bucket",
           "sample_tokens", "view_bucket"]
