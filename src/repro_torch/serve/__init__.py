"""Serving support shared by the port's servers (port of the
``serve/stats.py`` part of ``repro/serve``)."""
from repro_torch.serve.stats import ServingStats, percentile  # noqa: F401
