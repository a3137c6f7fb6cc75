"""Models of the port: the paper's CNN and MLP (``paper_nets``) and the
model zoo (``config``, ``common``, ``attention``, ``moe``, ``ssm``,
``xlstm``, ``transformer``: decoders, the VLM backbone and the
encoder-decoder), each the port of the module of the same name in
``repro.models``."""
