from tpu_asr_torch.configs.presets import PRESETS, TrainConfig, get_preset

__all__ = ["PRESETS", "TrainConfig", "get_preset"]
