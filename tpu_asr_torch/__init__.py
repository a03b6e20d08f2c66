"""tpu-asr, ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX reference `tpu_asr`, mirroring its layout
so that each module's counterpart sits under the same path. It imports
torch and numpy only: nothing of JAX and nothing of `tpu_asr`.

Entry points (`decode.recognizer.Recognizer`, `serve.AsrServer`,
`train.TrainStep`, `train_lm.LMTrainStep`, `python -m
tpu_asr_torch.serve`, `python -m tpu_asr_torch.train`, `python -m
tpu_asr_torch.train_lm`, `python -m tpu_asr_torch.recognize`, `python -m
tpu_asr_torch.compute_cmvn`) run on the CUDA card unless the caller asks
for `device="cpu"`; with no card and no explicit CPU request they raise.
`python -m tpu_asr_torch.score` and `python -m
tpu_asr_torch.prepare_data` run on the host.
Kernels that the JAX package wrote in Pallas are CUDA C++ sources under
`csrc/`, built with nvcc at first use into `_build/` (ignored by git); on
CPU tensors each wrapper runs its plain PyTorch version.

Ported so far (serving and training of the hybrid CTC/attention model,
with the transformer or the conformer encoder, of the CIF model and of
the transducer, the external LM, the decode CLIs, the aishell recipe's
data and CMVN CLIs, data and tensor parallelism):
  tpu_asr_torch.frontend   waveform -> log-mel + per-utterance or global
                           CMVN
  tpu_asr_torch.augment    SpecAugment (masks, time warp) on the device
  tpu_asr_torch.models     conv2d subsampling, transformer or conformer
                           encoder (with the offline chunk mask), decoder,
                           the hybrid CTC/attention objective, the CIF
                           model (assigner, fire, causal decoder), the
                           transducer (predictor, joint, aux CTC), the
                           external Transformer LM
  tpu_asr_torch.ops        exact top-k, CTC lattice, CTC loss kernels,
                           CTC prefix-scan kernel, CIF fire kernel,
                           label-smoothed CE, RNN-T loss
  tpu_asr_torch.decode     greedy CTC, joint CTC/attention beam, CTC
                           prefix beam, attention rescoring (each with
                           the LM), CIF greedy/beam, transducer greedy,
                           beam (with the LM) and rescoring, Recognizer
  tpu_asr_torch.train      Noam/Adam, TrainStep/Solver, checkpoints, CLI
                           (--num-devices: data-parallel ranks)
  tpu_asr_torch.parallel   data and tensor parallelism over
                           torch.distributed: the mesh of ranks, batch
                           shards, the tensor-parallel weight rules
  tpu_asr_torch.data       manifests (and espnet data.json), length
                           buckets, batch loader, synthetic corpora
  tpu_asr_torch.serve      micro-batching server + HTTP front end
  tpu_asr_torch.train_lm   the LM's trainer (CLI)
  tpu_asr_torch.recognize  manifest decode -> hypotheses + CER (CLI)
  tpu_asr_torch.score      hypotheses vs references -> CER (CLI)
  tpu_asr_torch.prepare_data  wav.scp/text, data.json or synthetic ->
                           manifest + char dict (CLI)
  tpu_asr_torch.compute_cmvn  manifest -> global CMVN stats .npz (CLI)
  tpu_asr_torch.utils      vocab, CER, result formatting, device choice
  tpu_asr_torch.weights    flax params -> torch modules, seeded random init
"""

__version__ = "0.1.0"

IGNORE_ID = -1  # padding id for targets (same as tpu_asr.IGNORE_ID)
