"""The whole batch: the least time the published peaks need for its product
FLOPs (counted over the reference) over the traced time a batch."""

from bench_port.harness.readers import mfu_pct as read

__all__ = ["read"]
