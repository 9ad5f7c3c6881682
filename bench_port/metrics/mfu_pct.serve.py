"""The whole request: the least time the published peaks need for its product
FLOPs (counted over the reference) over the traced time a request."""

from bench_port.harness.readers import mfu_pct as read

__all__ = ["read"]
