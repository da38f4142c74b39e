"""Device-time attribution for the serving step loop (port of
`dynamo_tpu/perf/steptrace.py`)."""
