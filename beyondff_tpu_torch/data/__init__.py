"""Dataset metadata, split lists and frame readers (the port's copy of
beyondff_tpu/data)."""

from beyondff_tpu_torch.data import replica, s3dis, scannet200, scannetpp  # noqa: F401
from beyondff_tpu_torch.data.readers import ReplicaReader, S3DISReader, ScanNetReader, build_dataset  # noqa: F401
