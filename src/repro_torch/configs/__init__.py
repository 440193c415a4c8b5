from repro_torch.configs.oscar import DataConfig, DiffusionConfig, OscarConfig

__all__ = ["DataConfig", "DiffusionConfig", "OscarConfig"]
