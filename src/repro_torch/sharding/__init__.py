"""Logical-axis sharding rules and parameter placements (port of
``repro.sharding``)."""
