from tpu_asr_torch.train.loop import EvalStep, Solver, TrainStep
from tpu_asr_torch.train.optim import NoamAdam, noam_schedule

__all__ = ["EvalStep", "Solver", "TrainStep", "NoamAdam", "noam_schedule"]
