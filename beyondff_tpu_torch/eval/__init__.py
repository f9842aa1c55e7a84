"""ScanNet-protocol instance-segmentation evaluation (AP/AP50/AP25, recall);
the port's copy of beyondff_tpu/eval."""

from beyondff_tpu_torch.eval.instance_eval import ScanNetEval  # noqa: F401
