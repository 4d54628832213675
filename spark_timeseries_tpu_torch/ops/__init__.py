"""Batched tensor ops of the port (counterpart of
``spark_timeseries_tpu/ops``)."""
