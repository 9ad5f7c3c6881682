"""The benchmark's own machinery: the manifest, configurations, statistics,
weights from the seed, spans and the device trace, costs and peaks, the
import check and the comparison that decides ``correct``. Nothing here names
a cell, a configuration or a metric: those are files that the manifest
names."""
