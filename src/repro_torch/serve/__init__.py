"""Serving stack of the port: paged continuous-batching engine."""
from repro_torch.serve.engine import (GenRequest, GenResult, RejectedError,
                                      ServingEngine, view_bucket)

__all__ = ["GenRequest", "GenResult", "RejectedError", "ServingEngine",
           "view_bucket"]
