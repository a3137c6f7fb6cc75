"""The paper's CNN and MLP (port of ``repro.models.paper_nets``)."""
