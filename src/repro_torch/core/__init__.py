"""Scheduling, wireless, diversity and the FEEL driver (port of
``repro.core``)."""
