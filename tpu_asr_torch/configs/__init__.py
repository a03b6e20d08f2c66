from tpu_asr_torch.configs.presets import PRESETS, Preset, get_preset

__all__ = ["PRESETS", "Preset", "get_preset"]
