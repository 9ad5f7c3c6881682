"""CUDA kernels the profiler saw launched in the window, a request."""

from bench_port.harness.readers import launches_per_unit as read

__all__ = ["read"]
