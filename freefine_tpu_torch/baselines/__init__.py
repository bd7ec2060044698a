"""GeoBench baseline-method cores of the port (mirrors `freefine_tpu.baselines`)."""
