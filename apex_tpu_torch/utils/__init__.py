"""Host-side utilities of the port: the metric instruments."""
