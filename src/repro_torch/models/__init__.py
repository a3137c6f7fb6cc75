"""Models of the port: the paper's CNN and MLP (``paper_nets``) and the
model zoo's dense decoder-only stack (``config``, ``common``,
``attention``, ``moe``, ``transformer``), each the port of the module of
the same name in ``repro.models``."""
