"""Visualization exports for every pipeline intermediate (the port's copy of
beyondff_tpu/visualization)."""

from beyondff_tpu_torch.visualization.visualize import SceneVisualizer  # noqa: F401
