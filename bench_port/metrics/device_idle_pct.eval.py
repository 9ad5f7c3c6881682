"""100 x (1 - the union of kernel intervals / the traced window)."""

from bench_port.harness.readers import device_idle_pct as read

__all__ = ["read"]
