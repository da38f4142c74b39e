"""The analytical performance model the live roofline gauges compare
against (port of the part of `dynamo_tpu/profiler` they use): chip
specifications and the timing model."""
