"""Cell specifications.

Of the reference's ``launch/specs.py`` the port has only
:func:`opt_config_for`; the cells' input structs and shardings are mesh
machinery and arrive with the next model-mesh slice (the models' own
mesh is ``launch.mesh.set_mesh`` and ``models.explicit_tp``; the train
state's specs are ``train.trainer.state_shardings``).
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from ..optim import adamw


def opt_config_for(cfg: ModelConfig) -> adamw.AdamWConfig:
    """8-bit optimizer state where fp32 moments would not fit memory."""
    bits = 8 if cfg.param_count() > 200e9 else 32
    return adamw.AdamWConfig(total_steps=10_000, state_bits=bits)
