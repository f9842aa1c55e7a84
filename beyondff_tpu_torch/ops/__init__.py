"""Device op namespace: the port's compute primitives in one place.

The port's counterpart of ``beyondff_tpu/ops``, under the same names.
Implementations live in :mod:`beyondff_tpu_torch.core` (plain PyTorch ops
with numpy oracles) and :mod:`beyondff_tpu_torch.kernels` (the hand-written
CUDA kernels' wrappers, which take their plain version on CPU tensors); this
module is the stable import surface for users composing custom pipelines.
``pairwise_iou`` and ``pairwise_iou_pallas`` are both the mask-IoU kernel's
wrapper (the JAX package keeps a jnp version beside its Pallas kernel; the
port's wrapper is the one entry for both), and ``flash_attention`` is the
flash kernel's ``attend``.
"""

from beyondff_tpu_torch.core.geometry import (  # noqa: F401
    fuse_projection,
    homogenize,
    lift_frames,
    lift_frames_packed,
    pack_masks,
    project_and_test,
    view_counts,
)
from beyondff_tpu_torch.core.masks import (  # noqa: F401
    connected_components,
    group_or_and_mean,
    mask_iou,
)
from beyondff_tpu_torch.kernels.flash_attention import attend as flash_attention  # noqa: F401
from beyondff_tpu_torch.kernels.mask_iou import pairwise_iou  # noqa: F401
from beyondff_tpu_torch.kernels.mask_iou import pairwise_iou as pairwise_iou_pallas  # noqa: F401
