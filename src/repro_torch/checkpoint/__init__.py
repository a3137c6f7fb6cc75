"""Checkpoints in the reference's msgpack file format (port of
``repro.checkpoint``)."""
