"""Configs of the port: the OSCAR experiment (``oscar.py``) and the LM
zoo's registry (``base.py``), where importing this package registers the
configs the port can run."""
from repro_torch.configs.base import (INPUT_SHAPES, InputShape, MambaConfig,
                                      ModelConfig, MoEConfig, XLSTMConfig,
                                      get_config, list_configs, register)
from repro_torch.configs.oscar import DataConfig, DiffusionConfig, OscarConfig
from repro_torch.configs import granite_20b  # noqa: F401  (registers)
from repro_torch.configs import gemma2_2b  # noqa: F401
from repro_torch.configs import phi35_moe  # noqa: F401
from repro_torch.configs import qwen2_7b  # noqa: F401
from repro_torch.configs import olmoe_1b_7b  # noqa: F401
from repro_torch.configs import qwen3_32b  # noqa: F401
from repro_torch.configs import jamba_15_large  # noqa: F401
from repro_torch.configs import xlstm_125m  # noqa: F401
from repro_torch.configs import hubert_xlarge  # noqa: F401
from repro_torch.configs import internvl2_1b  # noqa: F401
from repro_torch.configs.shapes import input_specs, smoke_config, smoke_shape

# the reference's order (its assignment table)
ARCH_IDS = [
    "hubert-xlarge", "granite-20b", "gemma2-2b", "phi3.5-moe-42b-a6.6b",
    "xlstm-125m", "internvl2-1b", "qwen2-7b", "olmoe-1b-7b", "qwen3-32b",
    "jamba-1.5-large-398b",
]

__all__ = ["ARCH_IDS", "DataConfig", "DiffusionConfig", "OscarConfig",
           "INPUT_SHAPES", "InputShape", "MambaConfig", "ModelConfig",
           "MoEConfig", "XLSTMConfig", "get_config", "input_specs",
           "list_configs", "register", "smoke_config", "smoke_shape"]
