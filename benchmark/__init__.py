"""The benchmark of tpu_asr_torch on an NVIDIA H100 (see run.py)."""
