"""Fine-tuning: data- and tensor-parallel train steps for the model zoo.

The reference has no training loop; this package adapts the 2D models to
new domains (contrastive CLIP tuning on scene vocabulary, SAM decoder
tuning on lifted pseudo-labels) with the dp x tp step the multi-process
dry run drives (``parallel/dryrun.py``).
"""

from beyondff_tpu_torch.training.trainer import (  # noqa: F401
    TrainState,
    clip_contrastive_loss,
    make_sharded_train_step,
)
