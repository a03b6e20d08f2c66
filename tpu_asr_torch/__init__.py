"""tpu-asr, ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX reference `tpu_asr`, mirroring its layout
so that each module's counterpart sits under the same path. It imports
torch and numpy only: nothing of JAX and nothing of `tpu_asr`.

Entry points (`decode.recognizer.Recognizer`, `serve.AsrServer`,
`train.TrainStep`, `python -m tpu_asr_torch.serve`, `python -m
tpu_asr_torch.train`) run on the CUDA card unless the caller asks for
`device="cpu"`; with no card and no explicit CPU request they raise.
Kernels that the JAX package wrote in Pallas are CUDA C++ sources under
`csrc/`, built with nvcc at first use into `_build/` (ignored by git); on
CPU tensors each wrapper runs its plain PyTorch version.

Ported so far (serving and training of the hybrid CTC/attention model):
  tpu_asr_torch.frontend   waveform -> log-mel + per-utterance CMVN
  tpu_asr_torch.augment    SpecAugment (masks, time warp) on the device
  tpu_asr_torch.models     conv2d subsampling, transformer encoder/decoder,
                           the hybrid CTC/attention objective
  tpu_asr_torch.ops        exact top-k, CTC lattice, CTC loss kernels,
                           CTC prefix-scan kernel, label-smoothed CE
  tpu_asr_torch.decode     greedy CTC, joint CTC/attention beam, Recognizer
  tpu_asr_torch.train      Noam/Adam, TrainStep/Solver, checkpoints, CLI
  tpu_asr_torch.data       manifests, length buckets, batch loader
  tpu_asr_torch.serve      micro-batching server + HTTP front end
  tpu_asr_torch.weights    flax params -> torch modules, seeded random init
"""

__version__ = "0.1.0"

IGNORE_ID = -1  # padding id for targets (same as tpu_asr.IGNORE_ID)
