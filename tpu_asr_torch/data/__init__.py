from tpu_asr_torch.data.bucketing import Bucket, make_buckets, plan_batches
from tpu_asr_torch.data.loader import DataLoader
from tpu_asr_torch.data.manifest import (Utterance, load_manifest,
                                         save_manifest)

__all__ = ["Utterance", "load_manifest", "save_manifest", "Bucket",
           "make_buckets", "plan_batches", "DataLoader"]
