"""Training and serving launchers (port of ``repro.launch``)."""
