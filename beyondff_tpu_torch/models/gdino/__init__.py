"""Grounding-DINO: Swin backbone, BERT text branch, deformable transformer."""

from beyondff_tpu_torch.models.gdino.model import GroundingDINO  # noqa: F401
