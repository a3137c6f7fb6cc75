from repro_torch.optim.optimizers import (OptimizerConfig, apply_updates,
                                          global_norm, init_state)

__all__ = ["OptimizerConfig", "apply_updates", "global_norm", "init_state"]
