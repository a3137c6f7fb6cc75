"""Synthetic data and the shard partitioner (port of ``repro.data``)."""
