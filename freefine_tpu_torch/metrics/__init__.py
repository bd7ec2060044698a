"""GeoBench metrics of the port (mirrors `freefine_tpu.metrics`): so far the
ground-truth coordinates of the mean-distance metric (`md`)."""
